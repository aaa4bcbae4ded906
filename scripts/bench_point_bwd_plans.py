"""Time the point-sample image gradient (`csrc/point_sample_bwd.cu`, K4 dimg)
under other launch plans than the one
`ops/point_sample_cuda.py::dimg_launch_plan` picks, at the criterion's shape
(points [120, 12544, 2], gradients [120, 12544, 1] into [120, 56, 56, 1]),
at 1 to 60 images of 12544 points (where the global kernel and the staged
one cross) and at 300 images of 2000 points, on one NVIDIA GPU.

    python3 scripts/bench_point_bwd_plans.py [--quick]

The C function executes whatever plan it is given, so each alternative is
one call with another plan: the staged kernel (each image summed in shared
memory) at 1, 2 and 4 blocks per image (a thread-block cluster), at 256,
512 and 1024 threads a block for the criterion's shape and 1024 elsewhere,
and the global kernel (atomics into a zeroed output). Each result must
agree with the plain version's autograd within chip_smoke.py's tolerance;
each time is device ms (`chip_smoke.device_time_ms`: calls captured in a
CUDA graph, replays between events), beside the bound,
`grid_sampler_2d_backward`'s device ms and whether two calls gave the same
bits. Last it prints the shared-memory atomic instructions of the built
library's SASS (`cuobjdump -sass`), where the toolkit has cuobjdump.
`--quick` times the chosen plan and global only.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (MASK_HW, NUM_POINTS, TOL_FP32, TRAIN_M, _grid, bound,  # noqa: E402
                        compare, device_time_ms, nbytes, point_corners, point_inputs)
from combo_avs_torch.ops import _build  # noqa: E402
from combo_avs_torch.ops import point_sample_cuda as k  # noqa: E402
from combo_avs_torch.ops.grid_sample import point_sample_plain  # noqa: E402

SHAPES = [  # name, image [N, H, W, C], points, threads swept
    ("train", (TRAIN_M, MASK_HW, MASK_HW, 1), NUM_POINTS, (256, 512, 1024)),
    *((f"{n}_images", (n, MASK_HW, MASK_HW, 1), NUM_POINTS, (1024,))
      for n in (1, 4, 8, 12, 16, 24, 30, 60)),
    ("300_images", (300, MASK_HW, MASK_HW, 1), 2000, (1024,)),
]
CLUSTERS = (1, 2, 4)


def staged_plan(N, H, W, C, P, cluster, threads):
    """The staged kernel at `cluster` blocks an image and `threads` a block,
    for fresh (16-byte aligned) inputs."""
    return k.DimgLaunchPlan("staged", threads, cluster, k._dimg_points_per_block(P, cluster),
                            (cluster, min(N, k.GRID_ROWS)), P % 2 == 0 and (P * C) % 4 == 0,
                            k.dimg_smem_bytes(H, W, C), 0)


def candidates(N, H, W, C, P, threads, sms, optin, quick):
    """(name, plan) for the plan's choice, global, then every staged cluster
    and thread count."""
    chosen = k.dimg_launch_plan(N, H, W, C, P, 0, 0, sms, optin)
    yield "chosen", chosen
    yield "global", k.dimg_launch_plan(N, H, W, C, P, 0, 0, sms, 0)
    if quick:
        return
    for cluster in CLUSTERS:
        for t in threads:
            plan = staged_plan(N, H, W, C, P, cluster, t)
            if plan != chosen:
                yield f"staged, {cluster} blocks an image, {t} threads", plan


def sass_atomics() -> str:
    """The shared and global atomic opcodes in the built library's SASS, by
    kernel."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", _build.library_path(k.BWD_SOURCE)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    found, kernel = collections.defaultdict(collections.Counter), "?"
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"\b((?:[A-Z]*ATOM[A-Z]*|RED[A-Z]*)(?:\.[A-Z0-9_]+)+)", line)
        if m:
            found[kernel][m.group(1)] += 1
    return "; ".join(f"{name}: {dict(ops)}" for name, ops in found.items()) or "none"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the chosen plan and global only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_point_bwd_plans: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    sms, optin = k.sm_count(dev.index), k.smem_optin(dev.index)
    for name, (N, H, W, C), P, threads in SHAPES:
        feat, pts = point_inputs(N, H, W, C, P, dev, seed=7)
        dout = torch.randn((N, P, C), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
        f_ = feat.clone().requires_grad_()
        out = point_sample_plain(f_, pts)
        want = torch.autograd.grad(out, f_, dout)[0]
        nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
        dlib = dout.permute(0, 2, 1)[..., None].contiguous()
        lib_ms, lib_source = device_time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            dlib, nchw, grid, 0, 0, False, [True, False]))
        bd = bound(nbytes(pts, dout, want), 2 * C * point_corners(pts, H, W))
        shape = f"[{N},{H},{W},{C}] at {P} points"
        print(f"{shape}: grid_sampler_2d_backward {lib_ms:.4f} ms device ({lib_source}), bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} on {smi}", flush=True)
        best = None
        for label, plan in candidates(N, H, W, C, P, threads, sms, optin, args.quick):
            fn = lambda: k.point_sample_dimg_cuda(pts, dout, (H, W), plan=plan)  # noqa: E731
            got = fn()
            compare(f"{shape} {label}", got, want, TOL_FP32)
            same = bool(torch.equal(got, fn()))
            ms, source = device_time_ms(fn)
            print(f"{shape} {label}: {plan}: {ms:.4f} ms device ({source}), "
                  f"{bd['bound_ms'] / ms:.0%} of the bound, {lib_ms / ms:.2f}x faster than the "
                  f"library; two calls bitwise equal: {same} on {smi}", flush=True)
            if best is None or ms < best[1]:
                best = (label, ms)
        print(f"{shape}: fastest {best[0]} at {best[1]:.4f} ms device on {smi}", flush=True)
    print(f"SASS atomics of {k.BWD_SOURCE}: {sass_atomics()}", flush=True)


if __name__ == "__main__":
    main()
