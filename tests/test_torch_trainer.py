"""The PyTorch port's training entry point on the CPU, at the tiny
flagship's widths over a `data/synth.py` S4 tree at 64^2:

* the slice as a whole at one step: config -> build_model / build_criterion
  / build_weight_dict / build_optimizer -> training mapper -> TrainLoader ->
  the training losses, against the same chain in the JAX package on the
  same weights (the port's seeded init through `convert_combo_checkpoint`)
  and the same criterion draws, in float64: every loss within 1e-9
  relative (tests/test_torch_train.py's bound); then one port train step;
* the loop (`train_net.main`, mirroring tests/test_trainer_loop.py::
  test_trainer_train_eval_best_resume on the port alone): 4 iterations,
  evaluation every 2, a checkpoint at 3 and at the end; losses logged and
  finite every iteration; step_N, model_best.pth (which `pred.py
  --config-file` reads back to the best mIoU), metrics.json and the
  evaluator's artifact written; resume from the saved iteration with the
  saved weights, optimizer and generator;
* the evaluation's out-of-memory retry: a step that raises
  torch.cuda.OutOfMemoryError above one video gives batch 1's metrics;
* `train_net` runs on the card unless told otherwise: without a CUDA
  device it raises rather than fall back to the CPU.
"""

import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from combo_avs_tpu import config as jax_config
from combo_avs_tpu.data.loader import TrainLoader as JaxTrainLoader
from combo_avs_tpu.losses.criterion import build_weight_dict as jax_build_weight_dict
from combo_avs_tpu.losses.criterion import total_loss as jax_total_loss
from combo_avs_tpu.models.meta_arch import build_model as jax_build_model
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.trainer import build_criterion as jax_build_criterion
from combo_avs_tpu.train.trainer import build_mapper as jax_build_mapper
from combo_avs_torch import config, pred, train_net
from combo_avs_torch.data.catalogs import DatasetCatalog, register_all
from combo_avs_torch.data.loader import TrainLoader
from combo_avs_torch.data.synth import make_s4
from combo_avs_torch.losses.criterion import build_criterion, build_weight_dict, total_loss
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import build_model
from combo_avs_torch.train import evaluate as evaluate_mod
from combo_avs_torch.train.optim import build_optimizer
from combo_avs_torch.train.train_step import compute_losses, make_train_step
from combo_avs_torch.train.trainer import Trainer, build_mapper
from tests.test_torch_config import S4, TINY_OPTS
from tests.test_torch_losses import jax_draws
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    REPO, one_torch_thread, release_worker_memory)

S = 64
LOSS_RTOL = 1e-9  # float64 on both sides, the same function
TINY_RUN = TINY_OPTS + [
    "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64",
    "INPUT.MIN_SIZE_TRAIN", "[48, 64, 80]", "INPUT.MAX_SIZE_TRAIN", "128",
    "INPUT.CROP.SIZE", "(64, 64)", "INPUT.SIZE_DIVISIBILITY", str(S),
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.0005", "SOLVER.MAX_ITER", "4",
    "SOLVER.CHECKPOINT_PERIOD", "3", "TEST.EVAL_PERIOD", "2", "DATALOADER.NUM_WORKERS", "1",
    "SEED", "0"]


def _nested(opts):
    """["A.B", "value", ...] -> {"A": {"B": value}} as a config file holds
    it (tuples as strings, like the shipped files)."""
    out: dict = {}
    for key, value in zip(opts[::2], opts[1::2]):
        node = out
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value if value.startswith("(") else yaml.safe_load(value)
    return out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A synthetic S4 tree (3 train, 2 val videos at 64^2), registered, and
    a tiny config file on top of the shipped S4 one."""
    root = str(tmp_path_factory.mktemp("tiny_s4"))
    make_s4(root, n_train=3, n_val=2, size=S)
    register_all(root)
    path = os.path.join(root, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"_BASE_": S4, **_nested(TINY_RUN)}, f, sort_keys=False)
    return {"root": root, "config": path}


def test_config_to_one_step_matches_jax(tiny):
    opts = ["SOLVER.IMS_PER_BATCH", "1", "MODEL.MASK_FORMER.EXACT_TOPK_POINTS", "True"]
    cfg = config.setup_cfg(tiny["config"], opts)
    jcfg = jax_config.setup_cfg(tiny["config"], opts)
    records = DatasetCatalog[cfg.DATASETS.TRAIN[0]]()

    model = init_weights(build_model(cfg), seed=0)
    crit, wd = build_criterion(cfg), build_weight_dict(cfg)
    loader = TrainLoader(records, build_mapper(cfg, is_train=True), batch_size=1, seed=0,
                         num_workers=1)
    batch = next(loader)
    loader.close()
    jm = jax_build_model(jcfg, deterministic=True)
    jcrit, jwd = jax_build_criterion(jcfg), jax_build_weight_dict(jcfg)
    jloader = JaxTrainLoader(records, jax_build_mapper(jcfg, is_train=True), batch_size=1,
                             num_workers=1)
    jbatch = next(jloader)
    jloader.close()
    assert wd == jwd and set(batch) == set(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _, T, K = batch["masks"].shape[:3]
    N = T  # one video
    key = jax.random.PRNGKey(7)
    npts = cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), convert_combo_checkpoint(
            sd, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers))
        inputs = [batch[k].astype(np.float64) for k in ("images", "audio_log_mel", "pre_masks",
                                                         "vid_temporal_mask")]
        targets = {"labels": batch["labels"].reshape(N, K),
                   "masks": batch["masks"].reshape(N, K, S, S).astype(np.float64),
                   "valid": batch["valid"].reshape(N, K)}
        fw = jnp.asarray(batch["gt_temporal_mask"].reshape(-1).astype(np.float64))

        @jax.jit
        def loss_fn(params):
            out = jm.apply({"params": params, "frozen": v64["frozen"]}, *inputs)
            losses = jcrit(key, out, jax.tree.map(jnp.asarray, targets), frame_weight=fw)
            return jax_total_loss(losses, jwd), losses

        jtot, jlosses = loss_fn(v64["params"])
        jlosses = {k: float(v) for k, v in jlosses.items()}
        draws = jax_draws(key, jm.dec_layers + 1, N, K, num_points=npts, matcher_points=npts)
    with torch.no_grad():
        net = init_weights(build_model(cfg), seed=0).double().eval()
        losses = compute_losses(net, crit, batch, torch.Generator(),
                                draws=[tuple(map(torch.from_numpy, d)) for d in draws])
        tot = float(total_loss(losses, wd))
    assert set(losses) == set(jlosses) and len(losses) == 3 * 3 + 2
    for k, want in jlosses.items():
        assert abs(float(losses[k]) - want) <= LOSS_RTOL * max(1.0, abs(want)), k
    assert abs(tot - float(jtot)) <= LOSS_RTOL * abs(float(jtot))

    step = make_train_step(model, crit, wd, build_optimizer(cfg, model),
                           torch.Generator().manual_seed(0))
    metrics = step(batch)
    assert set(metrics) == {"total_loss", *wd}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _tensorboard_scalars(log_dir):
    """{tag: [step, ...]} from the event files under `log_dir`, each record's
    framing and both CRCs checked, parsed with tensorboard's protos."""
    from tensorboard.compat.proto import event_pb2
    from tensorboard.summary.writer.record_writer import masked_crc32c

    out: dict = {}
    for name in sorted(os.listdir(log_dir)):
        assert name.startswith("events.out.tfevents."), name
        data = open(os.path.join(log_dir, name), "rb").read()
        i, versions = 0, []
        while i < len(data):
            head = data[i:i + 8]
            (n,), (head_crc,) = struct.unpack("<Q", head), struct.unpack("<I", data[i + 8:i + 12])
            rec = data[i + 12:i + 12 + n]
            (rec_crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
            assert head_crc == masked_crc32c(head) and rec_crc == masked_crc32c(rec)
            ev = event_pb2.Event.FromString(rec)
            assert ev.wall_time > 0
            if ev.file_version:
                versions.append(ev.file_version)
            for v in ev.summary.value:
                assert np.isfinite(v.simple_value)
                out.setdefault(v.tag, []).append(ev.step)
            i += 16 + n
        assert versions == ["brain.Event:2"] and i == len(data)
    return out


def test_train_net_loop_eval_best_resume(tiny):
    out = os.path.join(tiny["root"], "out")
    argv = ["--config-file", tiny["config"], "--datasets-root", tiny["root"], "--log-every", "1"]
    trainer = train_net.main(argv + ["OUTPUT_DIR", out])
    assert sorted(_tensorboard_scalars(os.path.join(out, "tb"))["total_loss"]) == [1, 2, 3, 4]

    rows = _rows(trainer.metrics_file)
    losses = [r for r in rows if "total_loss" in r]
    assert [r["iter"] for r in losses] == [1, 2, 3, 4]
    assert all(np.isfinite(r["total_loss"]) and r["s_per_iter"] > 0 for r in losses)
    evals = [r for r in rows if "mIoU" in r]
    assert [r["iter"] for r in evals] == [2, 4]
    assert trainer.best_ckpt.best == max(r["mIoU"] for r in evals)
    names = set(os.listdir(out))
    assert {"step_3", "step_4", "model_best.pth", "metrics.json", "metrics.jsonl"} <= names
    assert os.path.exists(os.path.join(out, "inference", "avss4_sem_seg_val",
                                       "sem_seg_evaluation.pth"))
    jrows = _rows(os.path.join(out, "metrics.json"))
    assert all("iteration" in r for r in jrows)
    assert any("sem_seg/mIoU" in r for r in jrows)

    # the eval entry point reads model_best.pth with the same config
    res = pred.main(["--datasets-root", tiny["root"], "--checkpoint",
                     os.path.join(out, "model_best.pth"), "--config-file", tiny["config"],
                     "--dataset", "avss4_sem_seg_val", "--batch-size", "1"])
    assert res["sem_seg"]["mIoU"] == trainer.best_ckpt.best

    # resume: the saved iteration, weights, optimizer and generator
    cfg = config.setup_cfg(tiny["config"], ["OUTPUT_DIR", out])
    resumed = Trainer(cfg)
    resumed.resume_or_load(resume=True)
    assert resumed.start_iter == 4 and resumed.optimizer.count == 4
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)
    assert torch.equal(resumed.generator.get_state(), trainer.generator.get_state())
    resumed.train(max_iter=5, log_every=1)
    assert [r["iter"] for r in _rows(trainer.metrics_file) if "total_loss" in r] == [1, 2, 3, 4,
                                                                                     5]
    assert "step_5" in os.listdir(out)

    # train_net.main in a fresh process (this one holds the JAX package)
    # imports none of jax, flax, yaml, cv2, tensorflow or the JAX package
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from combo_avs_torch import train_net\n"
            f"train_net.main({argv + ['--resume', '--max-iter', '6', 'OUTPUT_DIR', out]!r})\n"
            "bad = [m for m in ('jax', 'flax', 'yaml', 'cv2', 'combo_avs_tpu', 'tensorflow')\n"
            "       if m in sys.modules]\n"
            "print('loaded:', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-4000:]
    assert [r["iter"] for r in _rows(trainer.metrics_file) if "total_loss" in r] == [1, 2, 3, 4,
                                                                                     5, 6]
    tb = _tensorboard_scalars(os.path.join(out, "tb"))
    assert sorted(tb["total_loss"]) == [1, 2, 3, 4, 5, 6] and sorted(tb["sem_seg/mIoU"]) == [2, 4, 6]


def test_eval_oom_retry_gives_batch_one_metrics(tiny, monkeypatch):
    cfg = config.setup_cfg(tiny["config"])
    model = init_weights(build_model(cfg), seed=3).eval()
    real = evaluate_mod.make_eval_step
    calls = []

    def flaky(net, **kw):
        step = real(net, **kw)

        def run(batch):
            calls.append(batch["images"].shape[0])
            if batch["images"].shape[0] > 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
            return step(batch)
        return run

    monkeypatch.setattr(evaluate_mod, "make_eval_step", flaky)
    retried, _ = evaluate_mod.evaluate(model, "avss4_sem_seg_val", batch_size=2, size=S)
    assert calls == [2, 1, 1]
    single, _ = evaluate_mod.evaluate(model, "avss4_sem_seg_val", batch_size=1, size=S)
    assert retried == single

    def one_video_fails(batch):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        evaluate_mod.run_step(one_video_fails, {"images": torch.zeros(1, 5, S, S, 3)})

    def other_failure(batch):
        raise RuntimeError("not a memory failure")

    with pytest.raises(RuntimeError, match="not a memory"):
        evaluate_mod.run_step(other_failure, {"images": torch.zeros(2, 5, S, S, 3)})


def test_train_net_runs_on_the_card_by_default(tiny, monkeypatch):
    """Without a CUDA device, a config that does not say "cpu" raises: the
    entry point never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config-file", tiny["config"], "--datasets-root", tiny["root"],
            "OUTPUT_DIR", os.path.join(tiny["root"], "out_card"), "MODEL.DEVICE", "cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(["--eval-only"] + argv)
