"""The port's data parallelism in two real processes on the CPU (gloo), as
tests/test_multiprocess.py runs two `jax.distributed` processes:

* the 2-rank fp64 train step (dropout off) on a global batch of 2 videos
  whose ranks hold 1 and 3 valid masks and different frame weights,
  against the one-process step on the whole batch: losses, the gradient
  that reaches the clip and the updated weights within 1e-9 relative, and
  the same step with each rank's own normalizers far off;
* the same 2-rank step against the JAX package's `make_train_step` on the
  whole batch (SGD at rate 1, so its weights' change is its gradient), at
  tests/test_torch_train.py's fp64 bounds; both sides take the JAX step's
  criterion draws;
* the bf16 AMP step's 2-rank gradients against its one-process ones;
* the 2-rank `evaluate` (fp64) of a 3-video S4 split and a 2-video AVSS split
  against the one-process port and the JAX `evaluate`, within 1e-6;
* `train_net --num-devices 2 MODEL.DEVICE cpu`: one metrics.jsonl, a
  checkpoint that resumes, metrics equal to the one-process `Trainer.test`,
  and `pred --num-devices 2` on it;
* `utils/profiling.py` on the CPU.

The ranks (`tests/torch_ddp_worker.py`) meet through a file under the test's
temporary directory, not a TCP port, so parallel test workers cannot
collide. This process evaluates the one-process port while the two ranks
run; once they have ended, one launch of two ranks runs `train_net`'s rank
function and then `pred`'s, and meanwhile this process runs the JAX side
(`tests/ddp_jax_reference.py`), never beside the first two ranks: at most
four of the module's processes (this one, the launcher and two ranks) are
alive at once.
`python3 tests/peak_rss_tree.py -- python -m pytest tests/test_torch_ddp.py`
prints the module's peak memory summed over its processes.
"""

import ctypes
import gc
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_torch import config
from combo_avs_torch.data import catalogs
from combo_avs_torch.data.synth import make_avss, make_s4
from combo_avs_torch.parallel import distributed
from combo_avs_torch.train.evaluate import evaluate
from combo_avs_torch.train.trainer import Trainer
from combo_avs_torch.utils import profiling
from tests import ddp_jax_reference as jax_reference
from tests import torch_ddp_worker as w
from tests.test_torch_avss_train import AMP_GRAD_RL2, AMP_LOSS_RTOL
from tests.test_torch_config import S4
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    REPO, _port_kwargs, one_torch_thread, release_worker_memory)
from tests.test_torch_train import GRAD_FLOOR, GRAD_RL2, LOSS_RTOL
from tests.test_torch_trainer import TINY_RUN, _nested

METRIC_ATOL = 1e-6  # merged metrics against one pass (tests/test_multiprocess.py)
WORKER_TIMEOUT = 300


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _start(args):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs the two ranks (and the one-process port evaluations here
    meanwhile), then `train_net` and `pred` in one launch of 2 ranks (and the
    JAX side here meanwhile); returns what they all wrote."""
    d = str(tmp_path_factory.mktemp("ddp"))
    fields = _port_kwargs(jax_reference.tiny_jax_model())
    spec = {"fields": fields,
            "s4_root": make_s4(os.path.join(d, "s4"), 0, 3, size=w.S),
            # two 5-frame AVSS videos (v1s, v1m): one frame count, one JAX compile
            "avss_root": make_avss(os.path.join(d, "avss"), 0, 0, 2, size=32)}
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    jax_reference.draw(d, fields["dec_layers"])
    tn_root = os.path.join(d, "train_net")
    make_s4(tn_root, n_train=3, n_val=2, size=w.S)
    tn_cfg = os.path.join(tn_root, "tiny.yaml")
    with open(tn_cfg, "w") as f:
        yaml.safe_dump({"_BASE_": S4, **_nested(TINY_RUN)}, f, sort_keys=False)
    tn_out = os.path.join(d, "train_net_out")
    procs = [_start(["tests.torch_ddp_worker", str(r), "2", d]) for r in range(2)]
    try:
        w.register_splits(spec)
        one = {}
        for name, fields_, size in ((w.S4_SPLIT, fields, w.S),
                                    (w.AVSS_SPLIT, dict(fields, num_classes=71), 32)):
            one[name] = evaluate(w.tiny_model(fields_).eval(), name, batch_size=1,
                                 size=size)[0]["sem_seg"]
        outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
        # the JAX side once the two ranks have ended, beside the entry
        # launch, whose ranks (0.6 GiB each) hold half the first ones' memory
        procs.append(_start(["tests.torch_ddp_worker", "entry", tn_cfg, tn_root, tn_out]))
        jmetrics, jgrads = jax_reference.step(fields)
        jeval = jax_reference.evaluations(d, spec)
        jax.clear_caches()
        gc.collect()
        ctypes.CDLL("libc.so.6").malloc_trim(0)
        outs.append(procs[2].communicate(timeout=WORKER_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"{p.args[2:4]} failed:\n{err[-4000:]}"
    rows = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            rows.append(json.load(f))
    return {"dir": d, "fields": fields, "rows": rows, "jmetrics": jmetrics, "jgrads": jgrads,
            "jeval": jeval, "one": one,
            "train_net": {"root": tn_root, "config": tn_cfg, "out": tn_out,
                          "stdout": outs[2][0]}}


def test_two_rank_step_equals_one_process_fp64(ranks):
    """Losses (the metrics are the global batch's) and every gradient tensor
    that reaches the clip within 1e-9 relative of the one-process step on
    the whole batch (a tensor whose gradient is rounding noise is also
    allowed 1e-12 of the whole gradient's norm, as in
    tests/test_torch_train.py), and the updated weights within 1e-9 of the
    largest weight: AdamW divides a gradient entry below its eps of 1e-8 by
    that eps, so the noise tensors move by noise and a per-tensor relative
    bound on the weights would measure that noise. Both ranks hold the same
    weights after the step. The ranks' valid-mask counts differ, so each
    rank's own normalizers miss the global losses by far more."""
    r0, r1 = ranks["rows"]
    assert r0["world"] == r1["world"] == 2
    assert r0["weights_equal_rank0"] and r1["weights_equal_rank0"]
    fp = r0["fp64"]
    assert fp["n_losses"] == 1 + 3 * 3 + 2
    assert fp["loss_rel"] <= LOSS_RTOL, fp
    g = fp["grads"]
    bad = {k: v for k, v in g["tensors"].items()
           if v[0] > LOSS_RTOL * v[1] + GRAD_FLOOR * g["total"]}
    assert not bad and g["norm"] <= LOSS_RTOL, (bad, g["norm"])
    assert fp["weights_rel"] <= LOSS_RTOL, fp
    assert fp["local_normalizers_rel"] > 1e-2, fp


def test_two_rank_step_matches_jax_fp64(ranks):
    """The 2-rank step: the global losses within 1e-9 of the JAX
    `make_train_step`'s on the whole batch (the same draws), and the summed
    gradient (through the converter) within 1e-8 of each JAX leaf's norm,
    plus 1e-12 of the whole gradient's (tests/test_torch_train.py)."""
    got, want = ranks["rows"][0]["jax_step_metrics"], ranks["jmetrics"]
    assert set(got) == set(want) and len(got) == 12
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_RTOL * max(1.0, abs(v)), (k, got[k], v)
    assert ranks["rows"][1]["jax_step_metrics"] == got
    jm = jax_reference.tiny_jax_model()
    model = w.tiny_model(ranks["fields"])
    with np.load(os.path.join(ranks["dir"], "port_step_grads.npz")) as z:
        gsd = {n: z[n] if n in z.files else np.zeros(p.shape)
               for n, p in model.named_parameters()}
    gsd.update({n: np.zeros(b.shape) for n, b in model.named_buffers()})
    del model
    pgrads = jax.tree_util.tree_flatten_with_path(convert_combo_checkpoint(
        gsd, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)["params"])[0]
    del gsd
    total = np.sqrt(sum(np.sum(np.asarray(g) ** 2) for _, g in pgrads))
    bad, compared = [], 0
    jgrads = ranks["jgrads"]
    assert len(jgrads) == len(pgrads)
    for path, gp in pgrads:
        name = jax.tree_util.keystr(path)
        gj, gp = jgrads[name], np.asarray(gp)
        scale = max(np.linalg.norm(gj), np.linalg.norm(gp))
        if "audio_backbone" in name:
            assert scale == 0.0, name
            continue
        compared += 1
        err = np.linalg.norm(gj - gp)
        if err > GRAD_RL2 * scale + GRAD_FLOOR * total:
            bad.append(f"{name}: |diff| {err:.3e}, |g| {scale:.3e}")
    assert not bad, "\n".join(bad)
    assert compared > 100


def test_two_rank_amp_gradients_match_one_process(ranks):
    """The bf16 AMP step (fp32 weights) in 2 ranks against one process on the
    whole batch: the ranks' bf16 forwards run at other batch shapes, so they
    round differently; the losses and the whole gradient are held to the
    bounds the AMP step meets against the JAX package
    (tests/test_torch_avss_train.py)."""
    amp = ranks["rows"][1]["amp"]
    assert amp["loss_rel"] <= AMP_LOSS_RTOL, amp
    assert amp["grads"]["whole"] <= AMP_GRAD_RL2, amp


@pytest.mark.parametrize("split", [w.S4_SPLIT, w.AVSS_SPLIT])
def test_two_rank_evaluate_matches_one_process_and_jax(ranks, split):
    """Each rank scores its shard (S4: 2 and 1 of 3 videos, AVSS: 1 and 1 of
    2) and returns the
    merged metrics, equal on both ranks, to the one-process port's and the
    JAX `evaluate`'s (float64) within 1e-6; only rank 0 writes the results
    file."""
    r0, r1 = (r["eval"][split] for r in ranks["rows"])
    assert (r0["videos"], r1["videos"]) == ((2, 1) if split == w.S4_SPLIT else (1, 1))
    assert r0["ranks"] == r1["ranks"] == 2
    assert r0["metrics"] == r1["metrics"]
    for want in (ranks["one"][split], ranks["jeval"][split]):
        assert set(want) == set(r0["metrics"])
        for k, v in want.items():
            assert abs(r0["metrics"][k] - v) <= METRIC_ATOL, (k, r0["metrics"][k], v)
    d = ranks["dir"]
    assert os.path.isfile(os.path.join(d, "out0", "inference", split, "sem_seg_evaluation.pth"))
    assert not os.path.exists(os.path.join(d, "out1"))


def test_train_net_and_pred_two_devices_on_cpu(ranks, monkeypatch):
    """`train_net`'s rank function with MODEL.DEVICE cpu in a launch of two
    gloo ranks (`distributed.launch`, as `train_net --num-devices 2` makes
    it; one video each, 2 iterations, an evaluation and a checkpoint at 2):
    one metrics.jsonl, written by rank 0 alone, its rows once each; step_2
    resumes into a one-process Trainer, and that Trainer's evaluation of it
    equals the 2-rank run's merged metrics. Then, in the same ranks, `pred`'s
    rank function (`pred --num-devices 2 --device cpu`) on the
    model_best.pth it wrote printed one merged result, rank 0's, equal to
    the same evaluation."""
    tn = ranks["train_net"]
    with open(os.path.join(tn["out"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iter"] for r in rows if "total_loss" in r] == [1, 2]
    evals = [r for r in rows if "mIoU" in r]
    assert len(evals) == 1 and evals[0]["iter"] == 2
    assert all(np.isfinite(r["total_loss"]) for r in rows if "total_loss" in r)
    assert {"step_2", "model_best.pth", "metrics.json"} <= set(os.listdir(tn["out"]))
    assert not [n for n in os.listdir(tn["out"]) if n.startswith("combo_rendezvous_")]
    split = w.ENTRY_SPLIT
    # the standard split names, restored afterwards for other modules' tests
    for name in (f"avss4_sem_seg_{s}" for s in ("train", "val", "test")):
        monkeypatch.setitem(catalogs.DatasetCatalog, name, catalogs.DatasetCatalog.get(name))
        monkeypatch.setitem(catalogs.MetadataCatalog, name, catalogs.MetadataCatalog.get(name))
    catalogs.register_all(tn["root"])
    cfg = config.setup_cfg(tn["config"], ["OUTPUT_DIR", tn["out"]])
    trainer = Trainer(cfg)
    assert trainer.world.size == 1 and cfg.DATASETS.TEST[0] == split
    trainer.resume_or_load(resume=True)
    assert trainer.start_iter == 2
    got = trainer.test()["sem_seg"]
    assert got == {k: evals[0][k] for k in got}
    printed = [line for line in tn["stdout"].splitlines() if line.startswith(split)]
    assert printed == [f"{split} {got}"]


def test_profiling_on_the_cpu(tmp_path):
    """`trace` writes a Chrome trace holding the profiled ops and each span
    as a `combo_span` event, on the profiler's clock: a span's interval
    encloses a `record_function` opened inside it to within 0.25 ms at each
    end. `device_timer` times CPU tensors by perf_counter: positive seconds
    per call."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.span("combo.step"):
            with torch.profiler.record_function("inner_step"):
                (x @ x).sum()
            with profiling.span("combo.forward"), \
                    torch.profiler.record_function("inner_forward"):
                (x @ x).sum()
    (path,) = tmp_path.iterdir()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    spans = {e["name"]: e for e in events if e.get("cat") == profiling.SPAN_CATEGORY}
    marks = {e["name"]: e for e in events if e.get("name", "").startswith("inner_")}
    assert set(spans) == {"combo.step", "combo.forward"} and len(marks) == 2
    for name, mark in (("combo.step", "inner_step"), ("combo.forward", "inner_forward")):
        s, m = spans[name], marks[mark]
        assert s["ts"] <= m["ts"] + 250
        assert s["ts"] + s["dur"] >= m["ts"] + m["dur"] - 250
    seconds = profiling.device_timer(lambda a: a @ a, x, iters=4, repeats=2)
    assert 0 < seconds < 10


def test_world_of_one_launches_nothing():
    """Without a group, the world is one rank: `initialize()` with no
    arguments and no torchrun variables joins nothing."""
    for k in ("RANK", "WORLD_SIZE"):
        assert k not in os.environ
    assert distributed.initialize() == 0
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.is_main_process()
