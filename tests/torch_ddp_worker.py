"""One rank of the two-process tests of the port's data parallelism
(tests/test_torch_ddp.py), and the pieces both sides build alike.

    python -m tests.torch_ddp_worker RANK WORLD DIR
    python -m tests.torch_ddp_worker entry CONFIG ROOT OUT

DIR holds `spec.json` (the tiny flagship's fields, the synthetic trees) and
`jax_draws.npz` (the JAX step's criterion draws at the global batch's
shape); the rank joins a gloo group through a file in DIR and writes
`rank<R>.json` there (rank 0 also `port_step_grads.npz`). It imports torch
and the port only. Each rank runs, on its rows of one global batch of 2
videos whose ranks hold 1 and 3 valid masks:

* the fp64 train step, dropout off, on the JAX step's draws (the global
  batch's, of which each rank takes its rows); rank 0 also runs the
  one-process step on the whole batch and reports the largest differences
  of the losses, the gradients that reach the clip and the updated
  weights, and what local normalizers would have given; the metrics and
  the summed gradient also go to the parent, which holds them against JAX;
* the bf16 AMP step against the one-process AMP step (rank 1 reports);
* `evaluate` of a 3-video S4 split (fp64) and a 2-video AVSS split (fp64,
  71 classes), one video a batch: the merged metrics.

`entry` runs `train_net --num-devices 2` on the CPU (2 iterations, an
evaluation and a checkpoint at 2) and then `pred --num-devices 2` on the
model_best.pth it wrote, in one launch of two ranks (`entry_rank`).
"""

from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np
import torch

from combo_avs_torch.data import catalogs
from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict
from combo_avs_torch.losses.matcher import HungarianMatcher
from combo_avs_torch.models import fusion
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.parallel import distributed
from combo_avs_torch.parallel.mesh import shard_batch
from combo_avs_torch.train.evaluate import evaluate
from combo_avs_torch.train.optim import Optimizer
from combo_avs_torch.train.train_step import compute_losses, make_train_step

# tests/test_torch_losses.py's point counts (importing it would import jax)
NPTS, OS, ISR, MPTS = 64, 3.0, 0.75, 128
B, T, S, K = 2, 5, 64, 3  # the global batch: one video a rank
SEED = 0
S4_SPLIT, AVSS_SPLIT = "ddp_s4_val", "ddp_avss_test"
ENTRY_SPLIT = "avss4_sem_seg_val"  # the split train_net evaluates and pred scores


def global_batch() -> dict:
    """A loader-format S4 batch of B videos: video 0 (rank 0's) holds 1 valid
    slot and weights frame 0; video 1 (rank 1's) holds 3 and weights frames
    0 and 2, so every normalizer differs between the ranks."""
    rng = np.random.RandomState(11)
    valid = np.zeros((B, T, K), bool)
    valid[0, :, :1] = True
    valid[1] = True
    fw = np.zeros((B, T), np.float32)
    fw[0, 0] = fw[1, 0] = fw[1, 2] = 1.0
    return {
        "images": rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8),
        "audio_log_mel": rng.randn(B, T, 96, 64).astype(np.float32),
        "pre_masks": rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8),
        "labels": rng.randint(0, 2, (B, T, K)).astype(np.int32),
        "masks": rng.rand(B, T, K, S, S) > 0.5,
        "valid": valid,
        "gt_temporal_mask": fw,
    }


class InjectedCriterion(SetCriterion):
    """A SetCriterion whose draws are given, one layer's at a time, at the
    shape it asks for (the global batch's)."""

    def __init__(self, draws, **kw):
        super().__init__(**kw)
        self._draws = iter(draws)

    def draw(self, generator, N, K):
        d = next(self._draws)
        assert d[0].shape[0] == N and d[1].shape[0] == N * K, (d[0].shape, N, K)
        return d


def criterion(draws=None) -> SetCriterion:
    kw = dict(matcher=HungarianMatcher(num_points=MPTS), num_points=NPTS, oversample_ratio=OS,
              importance_sample_ratio=ISR)
    return SetCriterion(**kw) if draws is None else InjectedCriterion(draws, **kw)


class NormOptimizer(Optimizer):
    """The port's Optimizer, keeping the global norm of the gradient that
    reaches its clip, so that `pre_clip_grads` can undo the clip."""

    def step(self) -> None:
        grads = [p.grad for g in self.inner.param_groups for p in g["params"]
                 if p.grad is not None]
        self.norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        super().step()


def tiny_model(fields: dict, dtype=torch.float64) -> MaskFormer:
    return init_weights(MaskFormer(**fields, device="cpu"), seed=SEED).to(dtype)


def run_step(fields, batch, world, dtype=torch.float64, amp=False, draws=None):
    """One train step of the seeded tiny model: (metrics as floats, the
    model after the update, whose `.grad`s hold the gradient that reached
    the clip). The optimizer's moments are dropped on return."""
    model = tiny_model(fields, dtype)
    opt = NormOptimizer(model)
    wd = build_weight_dict(dec_layers=fields["dec_layers"] + 1)
    step = make_train_step(model, criterion(draws), wd, opt,
                           torch.Generator().manual_seed(SEED), amp=amp,
                           dropout_generator=torch.Generator().manual_seed(SEED + 1),
                           world=world)
    metrics = {k: float(v) for k, v in step(batch).items()}
    if opt.norm > opt.clip_value:  # the clip scaled the gradients by clip_value / norm
        with torch.no_grad():
            torch._foreach_mul_([p.grad for p in model.parameters() if p.grad is not None],
                                opt.norm / opt.clip_value)
    return metrics, model


def grads_of(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _max_rel(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / max(1.0, abs(want[k])) for k in want)


def grad_errors(got: dict, want: dict) -> dict:
    """Each tensor's |got - want| and |want| (L2), the whole gradient's
    norm, its rel-L2 distance, and the relative difference of the global
    norms."""
    assert set(got) == set(want)
    sq = lambda t: float((t.double() ** 2).sum())  # noqa: E731
    total = sum(sq(v) for v in want.values()) ** 0.5
    tensors = {k: (sq(got[k] - want[k]) ** 0.5, sq(want[k]) ** 0.5) for k in want}
    return {"tensors": tensors, "total": total,
            "whole": sum(e * e for e, _ in tensors.values()) ** 0.5 / total,
            "norm": abs(sum(sq(v) for v in got.values()) ** 0.5 - total) / total}


def register_splits(spec: dict) -> None:
    """The two evaluation splits under names no other test module uses."""
    s4, avss = spec["s4_root"], spec["avss_root"]
    catalogs.register(S4_SPLIT, lambda: catalogs.load_avss4_records(
        s4, "val", os.path.join(s4, "pre_SAM_mask")), dict(catalogs.BINARY_METADATA))
    catalogs.register(AVSS_SPLIT, lambda: catalogs.load_avss_records(
        avss, "test", os.path.join(avss, "pre_SAM_mask")), catalogs.avss_metadata(avss))


def evaluations(spec: dict, world, out_dir: str = "") -> dict:
    """The merged metrics of both splits, fp64, one video a batch."""
    register_splits(spec)
    out = {}
    for name, fields, size in ((S4_SPLIT, spec["fields"], S),
                               (AVSS_SPLIT, dict(spec["fields"], num_classes=71), 32)):
        res, timing = evaluate(tiny_model(fields).eval(), name, batch_size=1, size=size,
                               output_dir=out_dir, world=world)
        out[name] = {"metrics": res["sem_seg"], "videos": timing["videos"],
                     "ranks": timing["ranks"]}
    return out


def main(rank: int, size: int, d: str) -> None:
    torch.set_num_threads(1)
    fusion.DROPOUT = 0.0  # dropout off: the one-process step is the reference
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    distributed.initialize("file://" + os.path.join(d, "rendezvous"), size, rank, device="cpu")
    world = distributed.current()
    fields = spec["fields"]
    batch = global_batch()
    local = shard_batch(batch, rank, size)
    row = {"rank": rank, "world": world.size}
    with np.load(os.path.join(d, "jax_draws.npz")) as jd:
        draws = [tuple(torch.from_numpy(jd[f"{j}_{i}"]) for i in range(3))
                 for j in range(fields["dec_layers"] + 1)]

    # what each rank's losses would be with its own normalizers, summed
    crit = functools.partial(criterion(rows_of(draws, local, world)), world=distributed.World())
    with torch.no_grad():
        local_losses = compute_losses(tiny_model(fields).train(), crit, local,
                                      torch.Generator())
    summed = world.all_sum_(torch.stack(list(local_losses.values())))

    # the one-process references, side by side: rank 0 the fp64 step, rank 1
    # the AMP step, each keeping only its metrics, gradient and weights
    if rank == 0:
        m1, model1 = run_step(fields, batch, distributed.World(), draws=draws)
    else:
        ma1, amp1 = run_step(fields, batch, distributed.World(), dtype=torch.float32, amp=True)

    # the fp64 step against the one-process step; its metrics and summed
    # gradient to the parent, for JAX
    m2, model2 = run_step(fields, local, world, draws=draws)
    row["jax_step_metrics"] = m2
    weights = torch.cat([p.detach().reshape(-1) for p in model2.parameters()])
    rank0 = weights.clone()
    world.broadcast_(rank0)
    row["weights_equal_rank0"] = bool(torch.equal(weights, rank0))
    del weights, rank0
    if rank == 0:
        with torch.no_grad():
            row["fp64"] = {
                "loss_rel": _max_rel(m2, m1),
                "local_normalizers_rel": _max_rel(
                    dict(zip(local_losses, map(float, summed))),
                    {k: m1[k] for k in local_losses}),
                "grads": grad_errors(grads_of(model2), grads_of(model1)),
                "weights_rel": float(max((a - b).abs().max() for a, b in zip(
                    model2.parameters(), model1.parameters())) / max(
                    b.abs().max() for b in model1.parameters())),
                "n_losses": len(m1),
            }
        np.savez(os.path.join(d, "port_step_grads.npz"),
                 **{k: v.numpy() for k, v in grads_of(model2).items()})
        del model1
    del model2

    # the bf16 AMP step against the one-process AMP step
    ma2, amp2 = run_step(fields, local, world, dtype=torch.float32, amp=True)
    if rank == 1:
        row["amp"] = {"loss_rel": _max_rel(ma2, ma1),
                      "grads": grad_errors(grads_of(amp2), grads_of(amp1))}
        del amp1
    del amp2

    row["eval"] = evaluations(spec, world, out_dir=os.path.join(d, f"out{rank}"))
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    distributed.dist.destroy_process_group()


def rows_of(draws: list, local: dict, world) -> list:
    """This rank's rows of every layer's global draws, as the step's
    criterion takes them."""
    N, K = local["labels"].shape[0] * local["labels"].shape[1], local["labels"].shape[2]
    f = slice(world.rank * N, (world.rank + 1) * N)
    m = slice(world.rank * N * K, (world.rank + 1) * N * K)
    return [(pts[f], cand[m], tail[m]) for pts, cand, tail in draws]


def entry_rank(train_argv: list, pred_argv: list):
    """One rank of the entry launch: `train_net`'s rank function, then, once
    every rank has finished training (rank 0 writes model_best.pth),
    `pred`'s on the checkpoint."""
    from combo_avs_torch import pred, train_net

    train_net.run_rank(train_net.parse_args(train_argv))
    distributed.current().barrier()
    return pred.run_rank(pred.parse_args(pred_argv))


def entry(config_file: str, root: str, out: str) -> None:
    """`train_net --num-devices 2` on the CPU, then `pred --num-devices 2` on
    its model_best.pth (rank 0 prints the merged result), in one launch of
    two ranks, as the two CLIs launch theirs."""
    import importlib

    train_argv = ["--config-file", config_file, "--datasets-root", root, "--num-devices", "2",
                  "--max-iter", "2", "--log-every", "1", "OUTPUT_DIR", out, "TEST.EVAL_PERIOD",
                  "2", "SOLVER.CHECKPOINT_PERIOD", "2"]
    pred_argv = ["--datasets-root", root, "--checkpoint", os.path.join(out, "model_best.pth"),
                 "--config-file", config_file, "--dataset", ENTRY_SPLIT, "--batch-size", "1",
                 "--device", "cpu", "--num-devices", "2"]
    os.makedirs(out, exist_ok=True)
    # the spawned ranks find `entry_rank` by its module's name
    fn = importlib.import_module("tests.torch_ddp_worker").entry_rank
    distributed.launch(fn, 2, (train_argv, pred_argv), device_type="cpu", rendezvous_dir=out)


if __name__ == "__main__":
    if sys.argv[1] == "entry":
        entry(*sys.argv[2:5])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
