"""Time the point gather (`csrc/gather.cu`, K6) at both of its points a
thread (4 where the index and output take 16-byte vectors, 1 where the
index is not aligned for them) beside its floors, at the criterion
fallback's shape (src [120, 37632, 2] fp32, top-k indices [120, 9408]) in
int64 and int32 indices, on one NVIDIA GPU.

    python3 scripts/bench_gather_plans.py

For each index dtype: exact equality with torch.gather, then
`chip_smoke.k6_floors` (device ms in a CUDA-graph replay: an empty kernel
on the gather's grid, a streaming copy of the index into the output, the
gather warm and with its source flushed from L2), beside the bound (the
index, the output and the distinct source points once, over the card's
memory rate) and `torch.gather`'s device ms; then the gather on a copy of
the index that lies 8 bytes past a 16-byte boundary, which takes one point
a thread.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import K6_SHAPE, bound, device_time_ms, k6_floors, k6_inputs, nbytes  # noqa: E402
from combo_avs_torch.ops import gather_cuda as k  # noqa: E402


def misaligned_copy(idx: torch.Tensor) -> torch.Tensor:
    """idx's values in a tensor whose data starts 8 bytes past a 16-byte
    boundary (so the kernel takes one point a thread)."""
    step = 8 // idx.element_size()
    flat = torch.empty(idx.numel() + step, dtype=idx.dtype, device=idx.device)
    view = flat[step:].view(idx.shape)
    view.copy_(idx)
    assert view.data_ptr() % 16 == 8
    return view


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather_plans: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    G, NS, P = K6_SHAPE["G"], K6_SHAPE["NS"], K6_SHAPE["P"]
    src, idx64 = k6_inputs(G, NS, P, dev)
    touched = int(torch.unique(idx64 + torch.arange(G, device=dev)[:, None] * NS).numel())
    for idx in (idx64, idx64.int()):
        want = k.gather_points_plain(src, idx)
        bd = bound(nbytes(idx, want) + 8 * touched, 0)
        idx2 = idx.long()[..., None].expand(-1, -1, 2)
        lib, _ = device_time_ms(lambda: torch.gather(src, 1, idx2))
        tag = f"[{G},{NS},2] -> {P}, {str(idx.dtype).split('.')[-1]} indices"
        print(f"{tag}: bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bytes']} bytes); "
              f"torch.gather {lib:.4f} ms device on {smi}", flush=True)
        if not torch.equal(k.gather_points_cuda(src, idx), want):
            raise AssertionError(f"{tag}: differs from torch.gather")
        f = k6_floors(src, idx)
        print(f"{tag}, {k.VEC} points a thread: gather {f['warm_ms']:.4f} ms device "
              f"({bd['bound_ms'] / f['warm_ms']:.0%} of the bound), cold {f['cold_ms']:.4f}; "
              f"floors: empty {f['empty_ms']:.4f}, stream {f['stream_ms']:.4f} on {smi}",
              flush=True)
        off = misaligned_copy(idx)
        if not torch.equal(k.gather_points_cuda(src, off), want):
            raise AssertionError(f"{tag}, misaligned index: differs from torch.gather")
        ms, _ = device_time_ms(lambda: k.gather_points_cuda(src, off))
        print(f"{tag}, index 8 bytes off, 1 point a thread: gather {ms:.4f} ms device "
              f"({bd['bound_ms'] / ms:.0%} of the bound) on {smi}", flush=True)


if __name__ == "__main__":
    main()
