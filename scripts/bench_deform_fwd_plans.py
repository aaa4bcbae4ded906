"""Time the deformable-attention forward (`csrc/ms_deform_attn_fwd.cu`, K1)
under other launch plans than the one
`ops/deform_attn_cuda.py::fwd_launch_plan` picks, at the eval shape (value
[20, 1029, 8, 32]), the training shape ([40, 1029, 8, 32]) and the TTA
384^2 branch's shape ([20, 3024, 8, 32], levels 12^2, 24^2, 48^2), fp32 and
bf16, 3 levels x 4 points, on one NVIDIA GPU.

    python3 scripts/bench_deform_fwd_plans.py [--quick] [--shapes eval,train,tta384]

The C function executes whatever plan it is given, so each alternative is
one call with another plan: at the eval and training shapes, whose whole
slice fits a 32-warp block, the staged kernel (the whole (frame, head) value
slice in shared memory) at 8-32 warps a block and 1-8 query chunks per
(frame, head), and (fp32) the grouped plan on channel groups at 32 warps
and the chosen chunks; at the 384^2 shape, the whole slice at fewer warps
and each channel-group count that `grouped_fits` takes (fp32), at 16-32
warps and 2-6
chunks, wherever the block's shared memory fits the card's opt-in limit;
and the global kernel. Each result must agree with the plain version within
chip_smoke.py's K1 tolerance; each time is device ms
(`chip_smoke.device_time_ms`: calls captured in a CUDA graph, replays
between events), beside the bound and the plan's own choice. `--quick`
times the chosen plan and global only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (K1_LEVELS, K1_SHAPE, K1_TOL_BF16, K1_TOL_FP32, TRAIN_N,  # noqa: E402
                        bound, compare, deform_corners, device_time_ms, k1_inputs, nbytes,
                        tta_levels)
from combo_avs_torch.ops import deform_attn_cuda as k  # noqa: E402
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain  # noqa: E402

WARPS = (8, 16, 24, 32)
NARROW_WARPS = (16, 20, 24, 28, 32)
CHUNKS = (1, 2, 3, 4, 6, 8)
NARROW_CHUNKS = (2, 3, 4, 6)
SHAPES = {"eval": (K1_LEVELS, K1_SHAPE["B"]), "train": (K1_LEVELS, TRAIN_N),
          "tta384": (tta_levels(384), K1_SHAPE["B"])}


def candidates(levels, B, Lq, M, D, P, esize, optin, sms, quick):
    """(name, plan) for the plan's choice, global, then: where the whole
    slice fits a 32-warp block, the staged plan at 8-32 warps and 1-8
    chunks, and the grouped plan at 32 warps and the chosen chunks; where it
    does not, the whole slice (groups 1) and each channel-group count the
    grouped plan takes, at 16-32 warps and 2-6 chunks, wherever they fit."""
    chosen = k.fwd_launch_plan(levels, B, Lq, M, D, P, esize, optin, sms)
    yield "chosen", chosen
    yield "global", k.fwd_launch_plan(levels, B, Lq, M, D, P, esize, 0, sms)
    if quick:
        return
    whole_fits = k.staged_bytes(levels, D, P, esize) <= optin
    for groups in range(1, D + 1):
        if groups > 1 and not k.grouped_fits(D, esize, groups):
            continue
        warp_counts, chunk_counts = NARROW_WARPS, NARROW_CHUNKS
        if whole_fits:
            warp_counts = WARPS if groups == 1 else (32,)
            chunk_counts = CHUNKS if groups == 1 else (-(-Lq // chosen.chunk),)
        for warps in warp_counts:
            smem = k.staged_bytes(levels, D, P, esize, 32 * warps, groups)
            if smem > optin:
                print(f"groups {groups}, {warps} warps: skipped, {smem} bytes of shared memory "
                      f"a block, above the card's {optin}", flush=True)
                continue
            for chunks in chunk_counts:
                plan = k.staged_plan(levels, Lq, M, D, P, esize, 32 * warps, chunks, groups,
                                     "staged" if groups == 1 and whole_fits else "grouped")
                if plan != chosen:
                    yield f"{plan.kernel}, groups {groups}, {warps} warps, {chunks} chunks", plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the chosen plan and global only")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help=f"comma-separated, of {', '.join(SHAPES)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_deform_fwd_plans: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    M, D, P = K1_SHAPE["M"], K1_SHAPE["D"], K1_SHAPE["P"]
    optin, sms = k.smem_optin(dev.index), k.sm_count(dev.index)
    for name in args.shapes.split(","):
        levels, frames = SHAPES[name]
        Lq = sum(h * w for h, w in levels)
        for dtype, tol in ((torch.float32, K1_TOL_FP32), (torch.bfloat16, K1_TOL_BF16)):
            value, loc, w = k1_inputs(frames, M, D, P, levels, Lq, dtype, dev, seed=5)
            with torch.inference_mode():
                want = ms_deform_attn_plain(value, levels, loc, w)
                bd = bound(nbytes(value, loc, w, want), 2 * D * deform_corners(levels, loc))
                shape = f"{name} [{frames},{Lq},{M},{D}] {str(dtype).split('.')[-1]}"
                best = None
                for cand, plan in candidates(levels, frames, Lq, M, D, P, value.element_size(),
                                             optin, sms, args.quick):
                    fn = lambda: k.ms_deform_attn_cuda(value, levels, loc, w, plan=plan)  # noqa: E731
                    compare(f"{shape} {cand}", fn(), want, tol)
                    ms, source = device_time_ms(fn)
                    print(f"{shape} {cand}: {plan}: {ms:.4f} ms device ({source}), bound "
                          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bound_ms'] / ms:.0%} "
                          f"of it) on {smi}", flush=True)
                    if best is None or ms < best[1]:
                        best = (cand, ms, plan)
                print(f"{shape}: fastest {best[0]} at {best[1]:.4f} ms device ({best[2]}) on "
                      f"{smi}", flush=True)


if __name__ == "__main__":
    main()
