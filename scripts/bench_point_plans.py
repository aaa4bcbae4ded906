"""Time the point-sample forward (`csrc/point_sample_fwd.cu`, K3/K5) under
other launch plans than the one `ops/point_sample_cuda.py::launch_plan`
picks, at the training shapes, on one NVIDIA GPU.

    python3 scripts/bench_point_plans.py

The C function executes whatever plan it is given, so each alternative is
one call with another plan array: the staged kernel against the channels
kernel (gathers from global memory) on the 56^2 masks, scalar against
vector accesses, other points per block. Each output must equal the chosen
plan's bit for bit; each time is device ms (`chip_smoke.device_time_ms`:
calls captured in a CUDA graph, replays between events), beside the bound and
`F.grid_sample`'s device ms.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (GT_HW, MASK_HW, NUM_POINTS, NUM_QUERIES, TRAIN_K, TRAIN_M,  # noqa: E402
                        TRAIN_N, _grid, bound, device_time_ms, nbytes, point_corners,
                        point_inputs)
from combo_avs_torch.ops import point_sample_cuda as k  # noqa: E402

SHAPES = [  # name, feat [N, H, W, C], points: chip_smoke.py's training shapes
    ("k3_oversample", (TRAIN_M, MASK_HW, MASK_HW, 1), 3 * NUM_POINTS),
    ("k3_point_logits", (TRAIN_M, MASK_HW, MASK_HW, 1), NUM_POINTS),
    ("k3_point_labels", (TRAIN_M, GT_HW, GT_HW, 1), NUM_POINTS),
    ("k3_matcher_targets", (TRAIN_N, GT_HW, GT_HW, TRAIN_K), NUM_POINTS),
    ("k5_matcher_preds", (TRAIN_N, MASK_HW, MASK_HW, NUM_QUERIES), NUM_POINTS),
]
STEP = k.THREADS * k.POINTS_PER_THREAD


def alternatives(N, H, W, C, P, plan) -> dict:
    """name -> the C function's int array (N, H, W, C, P, kernel, vec,
    stage16, points per block, grid x, grid y) for each plan tried."""
    rows = plan.grid[1]

    def args(kernel, vec, stage16, per_block):
        return (N, H, W, C, P, kernel, int(vec), int(stage16), per_block, -(-P // per_block),
                rows)

    out = {"chosen": args(int(plan.kernel == "channels"), plan.vec, plan.stage16,
                          plan.points_per_block)}
    if plan.kernel == "staged":
        out["staged, scalar"] = args(0, False, plan.stage16, plan.points_per_block)
        for per_block in (STEP, 2 * STEP, 4 * STEP, 8 * STEP):
            if per_block != plan.points_per_block:
                out[f"staged, {per_block} points a block"] = args(0, plan.vec, plan.stage16,
                                                                  per_block)
        out["channels (no staging)"] = args(1, False, False, k.MAX_CHANNEL_POINTS)
    else:
        for per_block in (64, 128, k.MAX_CHANNEL_POINTS):
            if per_block != plan.points_per_block:
                out[f"channels, {per_block} points a block"] = args(1, plan.vec, False,
                                                                    per_block)
        if plan.vec:
            out["channels, scalar units"] = args(1, False, False,
                                                 max(1, min(k.MAX_CHANNEL_POINTS,
                                                            k.THREADS * 4 // C)))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_point_plans: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    fn = k._kernel("point_sample_fwd")
    with torch.inference_mode():
        for i, (name, (N, H, W, C), P) in enumerate(SHAPES):
            feat, pts = point_inputs(N, H, W, C, P, dev, seed=20 + i)
            plan = k.launch_plan(N, H, W, C, P, feat.data_ptr(), pts.data_ptr())
            bd = bound(nbytes(feat, pts) + N * P * C * 4, 2 * C * point_corners(pts, H, W))
            nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
            lib, _ = device_time_ms(lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                                          padding_mode="zeros",
                                                          align_corners=False))
            print(f"\n{name} [{N},{H},{W},{C}] at {P} points: bound {bd['bound_ms']:.4f} ms, "
                  f"F.grid_sample {lib:.4f} ms device; chosen plan {plan}", flush=True)
            want = None
            for alt, ints in alternatives(N, H, W, C, P, plan).items():
                out = torch.empty((N, P, C), dtype=torch.float32, device=dev)
                arr = (ctypes.c_int * 11)(*ints)

                def run(arr=arr, out=out, alt=alt):
                    err = fn(feat.data_ptr(), pts.data_ptr(), out.data_ptr(), arr,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{alt}: CUDA error {err}")

                run()
                torch.cuda.synchronize()
                want = out.clone() if want is None else want
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} {alt}: differs from the chosen plan's output")
                ms, src = device_time_ms(run)
                print(f"  {alt:<32} {ms:.4f} ms device ({src}), {bd['bound_ms'] / ms:.0%} of "
                      f"the bound, {ms / lib:.2f}x F.grid_sample", flush=True)


if __name__ == "__main__":
    main()
