"""Where the port's training loop spends its time: the host's data mapping,
the bare step, and the two together, at full width on one CUDA device.

    python3 scripts/profile_torch_train_loop.py [--steps 30] [--workers 8,2,1]

On a synthetic S4 tree (16 train videos at 224^2, `data/synth.py`) with the
shipped `avs_s4/COMBO_R50_bs8_90k.yaml` (8 videos x 5 frames, the full
augmentation), it measures, for each TrainLoader worker count:
  * map: the loader alone, s per batch of 8 videos (no step running), the
    time between one batch and the next;
  * step: `make_train_step` alone on the batches taken from the loader,
    synchronized each step (the loop's bare step);
  * loop: the trainer's order, `next(loader)` then the step, s/iter and
    data_time (the wait on the loader), with the loader mapping the next
    batches on its threads meanwhile;
each as the median with the 10th-90th percentile and the range over
`--steps` batches (after one warm-up), and the process's CPU seconds per
batch beside each. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from combo_avs_torch.config import setup_cfg  # noqa: E402
from combo_avs_torch.data.catalogs import DatasetCatalog, register_all  # noqa: E402
from combo_avs_torch.data.loader import TrainLoader  # noqa: E402
from combo_avs_torch.data.synth import make_s4  # noqa: E402
from combo_avs_torch.losses.criterion import build_criterion, build_weight_dict  # noqa: E402
from combo_avs_torch.models.layers import init_weights  # noqa: E402
from combo_avs_torch.models.meta_arch import build_model  # noqa: E402
from combo_avs_torch.train.optim import build_optimizer  # noqa: E402
from combo_avs_torch.train.train_step import make_train_step  # noqa: E402
from combo_avs_torch.train.trainer import _pinned, build_mapper  # noqa: E402

CONFIG = os.path.join(REPO, "combo_avs_tpu", "configs", "avs_s4", "COMBO_R50_bs8_90k.yaml")


def _cpu() -> float:
    t = os.times()
    return t.user + t.system


def _spread(xs) -> str:
    p10, med, p90 = np.percentile(xs, [10, 50, 90])
    return (f"median {med:.4f} (p10-p90 {p10:.4f}-{p90:.4f}, range {min(xs):.4f}-"
            f"{max(xs):.4f})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--workers", default="8,2,1")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        make_s4(tmp, 16, 0, size=224)
        register_all(tmp)
        cfg = setup_cfg(CONFIG)
        records = DatasetCatalog[cfg.DATASETS.TRAIN[0]]()
        model = init_weights(build_model(cfg), seed=0)
        dev = next(model.parameters()).device
        step = make_train_step(model, build_criterion(cfg), build_weight_dict(cfg),
                               build_optimizer(cfg, model),
                               torch.Generator(device=dev).manual_seed(0))
        B = cfg.SOLVER.IMS_PER_BATCH
        for workers in (int(w) for w in args.workers.split(",")):
            loader = TrainLoader(records, build_mapper(cfg, is_train=True), B, seed=0,
                                 num_workers=workers)
            batches, maps = [next(loader)], []
            c0, t0 = _cpu(), time.perf_counter()
            for _ in range(args.steps):
                batches.append(next(loader))
                maps.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
            map_cpu = (_cpu() - c0) / args.steps
            loader.close()

            step(_pinned(batches[0], dev))  # warm-up
            torch.cuda.synchronize()
            steps, c0 = [], _cpu()
            for b in batches[1:]:
                t0 = time.perf_counter()
                float(step(_pinned(b, dev))["total_loss"])
                steps.append(time.perf_counter() - t0)
            step_cpu = (_cpu() - c0) / args.steps
            del batches

            loader = TrainLoader(records, build_mapper(cfg, is_train=True), B, seed=0,
                                 num_workers=workers)
            float(step(_pinned(next(loader), dev))["total_loss"])
            times, waits = [], []
            c0 = _cpu()
            for _ in range(args.steps):
                t0 = time.perf_counter()
                b = next(loader)
                waits.append(time.perf_counter() - t0)
                float(step(_pinned(b, dev))["total_loss"])
                times.append(time.perf_counter() - t0)
            loop_cpu = (_cpu() - c0) / args.steps
            loader.close()
            print(f"[loop-profile] workers {workers}, {args.steps} batches each: map s/batch "
                  f"{_spread(maps)} (cpu {map_cpu:.2f} s); step s {_spread(steps)} (cpu "
                  f"{step_cpu:.2f} s); loop s/iter {_spread(times)}, data_time s/iter "
                  f"{_spread(waits)} (cpu {loop_cpu:.2f} s/iter) on {smi}", flush=True)

if __name__ == "__main__":
    main()
