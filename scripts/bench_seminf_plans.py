"""Time the fused semantic inference (`csrc/seminf_fwd.cu`, K7) under other
launch plans than the one `ops/seminf_cuda.py::launch_plan` picks, at the
eval tail's shape (mask [20, 100, 56, 56] -> [20, 2, 224, 224]), fp32 and
bf16 masks, on one NVIDIA GPU.

    python3 scripts/bench_seminf_plans.py [--quick]

The C function executes whatever plan it is given, so each alternative is
one call with another plan: the patch kernel with 4 x 4 and 2 x 2 patches
at 128, 256 and 512 threads a block, and the pixel kernel. Each result must
agree with the plain version within chip_smoke.py's K7 tolerances; each
time is device ms (`chip_smoke.device_time_ms`: calls captured in a CUDA
graph, replays between events), beside the bound. `--quick` times the chosen plan
and the pixel kernel only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (K7_SHAPE, K7_TOL_BF16, SIZE, TOL_FP32, bound, compare,  # noqa: E402
                        device_time_ms, nbytes, seminf_inputs)
from combo_avs_torch.ops import seminf_cuda as k  # noqa: E402

THREADS = (128, 256, 512)


def candidates(N, Q, C, h, w, H, W, quick):
    """(name, plan) for the plan's choice, the pixel kernel, then every patch
    side and thread count."""
    chosen = k.launch_plan(N, Q, C, h, w, H, W)
    yield "chosen", chosen
    yield "pixel", k.pixel_plan(Q, C, H, W)
    if quick:
        return
    for side in k.PATCH_SIDES:
        rows, cols = k.patch_grid(h, w, H, W, side)
        for threads in THREADS:
            plan = k.LaunchPlan("patch", threads, side, -(-(rows * cols) // threads), Q * C * 4)
            if plan != chosen:
                yield f"patch {side}x{side}, {threads} threads", plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the chosen plan and pixel only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_seminf_plans: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    N, Q, C, h, w = (K7_SHAPE[key] for key in ("N", "Q", "C", "h", "w"))
    H = W = SIZE
    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, K7_TOL_BF16)):
        cls, mask, _ = seminf_inputs(N, Q, C, h, w, dtype, dev, seed=5)
        with torch.inference_mode():
            want = k.semantic_inference_plain(cls, mask, (H, W))
            bd = bound(nbytes(cls, mask, want), N * H * W * Q * (12 + 2 * C))
            shape = f"[{N},{Q},{h},{w}] {str(dtype).split('.')[-1]} -> {H}x{W}"
            best = None
            for name, plan in candidates(N, Q, C, h, w, H, W, args.quick):
                fn = lambda: k.seminf_cuda(cls, mask, (H, W), plan=plan)  # noqa: E731
                compare(f"{shape} {name}", fn(), want, tol)
                ms, source = device_time_ms(fn)
                print(f"{shape} {name}: {plan}: {ms:.4f} ms device ({source}), bound "
                      f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bound_ms'] / ms:.0%} "
                      f"of it) on {smi}", flush=True)
                if best is None or ms < best[1]:
                    best = (name, ms)
            print(f"{shape}: fastest {best[0]} at {best[1]:.4f} ms device on {smi}", flush=True)


if __name__ == "__main__":
    main()
