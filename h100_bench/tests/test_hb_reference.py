"""The plain reference against the port on the CPU at a tiny size: the same
key names and shapes at the full widths, and one run of the harness whose
comparison holds to float32 noise."""

import pytest
import torch

from h100_bench import program, run, spec
from h100_bench.reference import model as ref_model
from h100_bench.tests import tiny


@pytest.mark.parametrize("config", ["combo_pvtv2b5_ms3", "combo_r50_s4"])
def test_reference_has_the_port_keys(config):
    conf = spec.load_json(f"{spec.PKG}/configs/{config}.json")
    model, _ = program.build(dict(conf, device="meta"), "train", "meta")
    ref = ref_model.build(conf["model"], "meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in ref.parameters()) == conf["parameters"]
    trained = {n for n, p in model.named_parameters() if not n.startswith("audio_backbone.")}
    assert trained == {n for n, p in ref.named_parameters() if not n.startswith("audio_backbone.")}


TIGHT = {"first_output_gap": 1e-4, "loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


@pytest.mark.parametrize("name", ["r50_s4_train", "pvt_ms3_train"])
def test_train_cell_agrees_with_reference(name, monkeypatch):
    out = run.run_cell(tiny.cell(name, monkeypatch, TIGHT), 2 ** 31 + 12345, 0.1, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["_notes"]["numbers"]["left_out"] < 10


def test_eval_cell_agrees_with_reference_in_fp32(monkeypatch):
    c = tiny.cell("eval", monkeypatch, {"sem_gap": 1e-4})
    c["config"]["precision"]["eval"]["dtype"] = "float32"
    out = run.run_cell(c, 2 ** 31 + 777, 4.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4


def test_seed_makes_the_inputs():
    from h100_bench import traffic, weights

    t = spec.load_json(f"{spec.PKG}/workloads/r50_s4_train.json")["traffic"]
    t = dict(t, videos=1, size=32, pool=2)
    a, b = traffic.pool(t, True, 2 ** 33 + 1, "cpu"), traffic.pool(t, True, 2 ** 33 + 1, "cpu")
    c = traffic.pool(t, True, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[i][k], b[i][k]) for i in range(2) for k in a[i])
    assert not torch.equal(a[0]["images"], c[0]["images"])
    assert not torch.equal(a[0]["images"], a[1]["images"])
    schema = weights.schema(ref_model.build(spec.load_json(
        f"{spec.PKG}/configs/combo_r50_s4.json")["model"], "meta"))
    w1, w2 = weights.make(schema[:40], 5, "cpu"), weights.make(schema[:40], 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
