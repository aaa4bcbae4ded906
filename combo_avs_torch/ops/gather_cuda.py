"""Point gather on the card: the wrapper of `csrc/gather.cu` (the TPU's K6,
`combo_avs_tpu/ops/gather_pallas.py::gather_lanes`) and its plain version.

`gather_points(src [G, NS, 2], idx [G, P]) -> [G, P, 2]` is out[g, p] =
src[g, idx[g, p]] for float32 (x, y) points `src` and int64 or int32 `idx`
with 0 <= idx < NS. A CPU tensor takes the plain version, `torch.gather`; a
CUDA tensor launches the kernel, which takes the indices as given (they come
from `torch.topk`; a range check on the device would synchronise every call).

`launches` counts the kernel's launches in this process, incremented where it
is launched and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from combo_avs_torch.ops import _build

SOURCE = "gather.cu"

launches = 0


def gather_points_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, src.shape[-1]))


def _kernel():
    fn = _build.load(SOURCE).gather_points
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gather_points_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA tensors: src [G, NS, 2] float32,
    idx [G, P] int64 or int32 -> [G, P, 2] float32."""
    global launches
    if not (src.is_cuda and idx.is_cuda) or src.device != idx.device:
        raise ValueError("gather_points_cuda: src and idx must be CUDA tensors on one device")
    if src.dtype != torch.float32 or idx.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"gather_points_cuda: src must be float32 and idx int64 or int32, got "
                        f"{src.dtype} and {idx.dtype}")
    if not (src.is_contiguous() and idx.is_contiguous()) or src.data_ptr() % 8:
        raise ValueError("gather_points_cuda: inputs must be contiguous, src 8-byte aligned")
    if src.dim() != 3 or src.shape[2] != 2 or idx.dim() != 2 or idx.shape[0] != src.shape[0] \
            or min(*src.shape, *idx.shape) < 1:
        raise ValueError(f"gather_points_cuda: src {tuple(src.shape)} must be [G, NS, 2] and "
                         f"idx {tuple(idx.shape)} [G, P], non-empty")
    G, NS = src.shape[:2]
    P = idx.shape[1]
    if G > 65535 or max(NS, P) >= 2**30:
        raise ValueError(f"gather_points_cuda: [{G}, {NS}] -> {P} is out of range (at most "
                         "65535 rows and 2^30 - 1 points)")
    out = torch.empty((G, P, 2), dtype=torch.float32, device=src.device)
    err = _kernel()(src.data_ptr(), idx.data_ptr(), out.data_ptr(), G, NS, P,
                    idx.element_size(), torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_points launch failed: CUDA error {err}")
    launches += 1
    return out


def gather_points(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[g, p] = src[g, idx[g, p]]: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    return gather_points_cuda(src, idx) if src.is_cuda else gather_points_plain(src, idx)
