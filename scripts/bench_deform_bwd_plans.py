"""Time the deformable-attention backward (`csrc/ms_deform_attn_bwd.cu`, K2)
under other launch plans than the one
`ops/deform_attn_cuda.py::bwd_launch_plan` picks, at the training shape
(value [40, 1029, 8, 32] fp32, 3 levels x 4 points), on one NVIDIA GPU.

    python3 scripts/bench_deform_bwd_plans.py

The C function executes whatever plan it is given, so each alternative is
one call with another plan: the level-slice kernel at 8, 16, 24 and 32
warps a block (where its shared memory fits the card's opt-in limit), and
the global kernel. Each result must agree with autograd of the
plain version within chip_smoke.py's TOL_FP32; each time is device ms
(`chip_smoke.device_time_ms`: calls captured in a CUDA graph, replays
between events), beside the bound.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (K1_LEVELS, K1_SHAPE, TOL_FP32, TRAIN_N, bound, compare,  # noqa: E402
                        deform_corners, device_time_ms, k1_inputs, nbytes)
from combo_avs_torch.ops import deform_attn_cuda as k  # noqa: E402
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_deform_bwd_plans: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    B, M, D, P = TRAIN_N, K1_SHAPE["M"], K1_SHAPE["D"], K1_SHAPE["P"]
    levels = K1_LEVELS
    Lq = sum(h * w for h, w in levels)
    value, loc, w = k1_inputs(B, M, D, P, levels, Lq, torch.float32, dev, seed=3)
    g = torch.randn((B, Lq, M * D), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
    want = torch.autograd.grad(ms_deform_attn_plain(leaves[0], levels, leaves[1], leaves[2]),
                               leaves, g)
    optin = k.smem_optin(dev.index)
    chosen = k.bwd_launch_plan(levels, Lq, M, D, P, optin)
    plans = {"chosen": chosen}
    if chosen.kernel == "level_slice":
        rows = max(h * w for h, w in levels)
        for threads in (256, 512, 768, 1024):
            smem = k.level_slice_bytes(rows, D, P, threads)
            if threads != chosen.threads and smem <= optin:
                plans[f"level_slice, {threads // 32} warps"] = chosen._replace(
                    threads=threads, smem_bytes=smem)
    plans["global"] = k.bwd_launch_plan(levels, Lq, M, D, P, 0)
    bd = None
    for name, plan in plans.items():
        fn = lambda: k.ms_deform_attn_bwd_cuda(value, levels, loc, w, g, plan=plan)  # noqa: E731
        got = fn()
        for n, a, b in zip(("value", "loc", "weights"), got, want):
            compare(f"[{name}] d{n}", a, b, TOL_FP32)
        if bd is None:
            bd = bound(nbytes(value, loc, w, g, *got), 10 * D * deform_corners(levels, loc))
        ms, source = device_time_ms(fn)
        print(f"{name}: {plan}: {ms:.4f} ms device ({source}), bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']} ({bd['bound_ms'] / ms:.0%} of it) on {smi}", flush=True)


if __name__ == "__main__":
    main()
