"""Point gather on the card: the wrapper of `csrc/gather.cu` (the TPU's K6,
`combo_avs_tpu/ops/gather_pallas.py::gather_lanes`) and its plain version.

`gather_points(src [G, NS, 2], idx [G, P]) -> [G, P, 2]` is out[g, p] =
src[g, idx[g, p]] for float32 (x, y) points `src` and int64 or int32 `idx`
with 0 <= idx < NS. A CPU tensor takes the plain version, `torch.gather`; a
CUDA tensor launches the kernel, which takes the indices as given (they come
from `torch.topk`; a range check on the device would synchronise every call).

`points_per_thread` sets the kernel's points a thread, 4 or 1, a pure
function of the index's element size and the pointers' alignment.
`gather_floor_cuda` runs the kernel's two floors (an empty kernel on the
same grid, a streaming copy of the index into the output) for measurement;
no caller of the gather runs them.

`launches` counts the gather's launches in this process, incremented where
it is launched and nowhere else (not by the floors).
"""

from __future__ import annotations

import ctypes
import torch

from combo_avs_torch.ops import _build

SOURCE = "gather.cu"

launches = 0
# the C functions' parameters, as ctypes passes them
ARGTYPES = {
    # gather_points(src, idx, out, G, NS, P, index_bytes, vec, stream)
    "gather_points": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    # gather_floor(idx, out, G, P, index_bytes, mode, stream)
    "gather_floor": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
FLOORS = ("stream", "empty")  # gather_floor's mode codes 0, 1
# points a thread where the pointers allow 16-byte vectors (4 was the
# fastest of 1, 2, 4 and 8 at the criterion's shape in int64; PERF.md, K6
# findings)
VEC = 4
_bound = {}  # the ctypes functions, bound once per process


def points_per_thread(index_bytes: int, idx_ptr: int, out_ptr: int) -> int:
    """VEC points a thread, or one where the index is not aligned to
    min(16, VEC * index_bytes) bytes or the output to 16 (then the kernel
    takes no vector loads or stores)."""
    aligned = idx_ptr % min(16, VEC * index_bytes) == 0 and out_ptr % 16 == 0
    return VEC if aligned else 1


def gather_points_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, src.shape[-1]))


def _kernel(name: str):
    if name not in _bound:
        fn = getattr(_build.load(SOURCE), name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return _bound[name]


def _check(src: torch.Tensor, idx: torch.Tensor, name: str):
    if not (src.is_cuda and idx.is_cuda) or src.get_device() != idx.get_device():
        raise ValueError(f"{name}: src and idx must be CUDA tensors on one device")
    if src.dtype != torch.float32 or idx.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"{name}: src must be float32 and idx int64 or int32, got "
                        f"{src.dtype} and {idx.dtype}")
    if not (src.is_contiguous() and idx.is_contiguous()) or src.data_ptr() % 8:
        raise ValueError(f"{name}: inputs must be contiguous, src 8-byte aligned")
    if src.dim() != 3 or src.shape[2] != 2 or idx.dim() != 2 or idx.shape[0] != src.shape[0] \
            or src.numel() == 0 or idx.numel() == 0:
        raise ValueError(f"{name}: src {tuple(src.shape)} must be [G, NS, 2] and "
                         f"idx {tuple(idx.shape)} [G, P], non-empty")
    G, NS, _ = src.shape
    P = idx.shape[1]
    if G > 65535 or max(NS, P) >= 2**30:
        raise ValueError(f"{name}: [{G}, {NS}] -> {P} is out of range (at most "
                         "65535 rows and 2^30 - 1 points)")
    return G, NS, P


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def gather_points_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA tensors: src [G, NS, 2] float32,
    idx [G, P] int64 or int32 -> [G, P, 2] float32, at `points_per_thread`
    points a thread; a launch that fails raises."""
    global launches
    G, NS, P = _check(src, idx, "gather_points_cuda")
    out = torch.empty((G, P, 2), dtype=torch.float32, device=src.device)
    vec = points_per_thread(idx.element_size(), idx.data_ptr(), out.data_ptr())
    _raise_on(_kernel("gather_points")(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), G, NS, P, idx.element_size(), vec,
        torch._C._cuda_getCurrentRawStream(src.get_device())), f"gather_points_cuda ({vec})")
    launches += 1
    return out


def gather_floor_cuda(src: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """One of the gather's floors on its grid at VEC points a thread, for
    measurement: "empty" (the kernel returns at once; the output is left
    unwritten) or "stream" (the index's bits copied into the output, no
    gather); the index and output must take VEC-point vectors. Not counted
    in `launches`."""
    if mode not in FLOORS:
        raise ValueError(f"gather_floor_cuda: mode {mode!r} is not 'empty' or 'stream'")
    G, _, P = _check(src, idx, "gather_floor_cuda")
    out = torch.empty((G, P, 2), dtype=torch.float32, device=src.device)
    _raise_on(_kernel("gather_floor")(
        idx.data_ptr(), out.data_ptr(), G, P, idx.element_size(), FLOORS.index(mode),
        torch._C._cuda_getCurrentRawStream(src.get_device())), f"gather_floor_cuda ({mode})")
    return out


def gather_points(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[g, p] = src[g, idx[g, p]]: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    return gather_points_cuda(src, idx) if src.is_cuda else gather_points_plain(src, idx)
