"""`correct` against the cells' own limits, on the CPU at a tiny size: a
sound run holds; the control in the program's place (the bf16 AMP step for
float32 training) and each fault a training cell can have, planted under
the timed path, do not."""

import pytest

from h100_bench import calibrate, run, spec
from h100_bench.tests import tiny

SEED = 2 ** 31 + 4242
TRAIN = ["r50_s4_train", "pvt_ms3_train"]


def _limits(name):
    return spec.load_json(f"{spec.PKG}/workloads/{name}.json")["limits"]


def _run(name, monkeypatch, seconds=0.1):
    return run.run_cell(tiny.cell(name, monkeypatch, _limits(name)), SEED, seconds, False, "cpu")


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(name, monkeypatch):
    out = _run(name, monkeypatch, seconds=3.0)
    assert out["correct"], out["checks"]


def test_state_left_unchanged_is_not_correct(monkeypatch):
    import torch
    from combo_avs_torch.train import optim

    step = optim.Optimizer.step

    def unchanged(self):  # the update runs, and the parameters come back as they were
        kept = [p.detach().clone() for p in self.params]
        step(self)
        with torch.no_grad():
            for p, k in zip(self.params, kept):
                p.copy_(k)

    monkeypatch.setattr(optim.Optimizer, "step", unchanged)
    out = _run("r50_s4_train", monkeypatch)
    assert not out["correct"]
    assert out["_notes"]["numbers"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_is_not_correct(name, monkeypatch):
    undo = calibrate.half_batch()
    try:
        out = _run(name, monkeypatch)
    finally:
        undo()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_control_is_not_correct(name, monkeypatch):
    """The program's bf16 AMP step in place of its float32 one."""
    cell = tiny.cell(name, monkeypatch, _limits(name))
    cell["config"]["precision"]["train"]["amp"] = True
    cell["config"]["opts"] += ["SOLVER.AMP.ENABLED", True]
    out = run.run_cell(cell, SEED, 0.1, False, "cpu")
    assert not out["correct"], out["checks"]
