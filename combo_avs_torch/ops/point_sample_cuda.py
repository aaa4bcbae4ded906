"""PointRend point sampling on the card: the wrappers of the forward kernel
(`csrc/point_sample_fwd.cu`, the TPU's K3 and K5) and the two backward
kernels (`csrc/point_sample_bwd.cu`, the TPU's K4), and their
`torch.autograd.Function`.

`point_sample_cuda(feat [N, H, W, C], points [N, P, 2]) -> [N, P, C]` is what
`ops.grid_sample.point_sample` calls for a CUDA tensor. Its backward launches
the image-gradient kernel when `feat` needs a gradient and the
point-gradient kernel only when `points` do (on the training path they never
do: the criterion's points are drawn, not learned). Every wrapper raises on a
tensor it cannot take; none falls back to the plain version.

`fwd_launches`, `dimg_launches` and `dxy_launches` count the kernels'
launches in this process, each incremented where its kernel is launched and
nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from combo_avs_torch.ops import _build

FWD_SOURCE = "point_sample_fwd.cu"
BWD_SOURCE = "point_sample_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)

fwd_launches = 0
dimg_launches = 0
dxy_launches = 0

_SIGNATURES = {
    # name: (source, pointer count)
    "point_sample_fwd": (FWD_SOURCE, 3),
    "point_sample_bwd_dimg": (BWD_SOURCE, 3),
    "point_sample_bwd_dxy": (BWD_SOURCE, 4),
}


def _kernel(name: str):
    source, n_ptr = _SIGNATURES[name]
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _log2_group(C: int) -> int:
    """Lanes per point: the smallest power of two >= C, at most 32."""
    return min(5, max(0, (C - 1).bit_length()))


def _check(name: str, points: torch.Tensor, *others: torch.Tensor):
    """Every tensor a float32, contiguous CUDA tensor on one device; points
    [N, P, 2] with N, P >= 1. Returns (N, P)."""
    tensors = (points, *others)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every input must be a CUDA tensor, all on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: inputs must be float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if points.dim() != 3 or points.shape[2] != 2 or min(points.shape[:2]) < 1:
        raise ValueError(f"{name}: points must be [N, P, 2], got {tuple(points.shape)}")
    return points.shape[0], points.shape[1]


def _check_image(name: str, N: int, H: int, W: int, C: int) -> None:
    if min(H, W, C) < 1 or H * W >= 2**31:
        raise ValueError(f"{name}: image [{N}, {H}, {W}, {C}] is empty or too large for "
                         "32-bit pixel indices")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def point_sample_fwd_cuda(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: feat [N, H, W, C] at points [N, P, 2] in
    [0, 1] -> [N, P, C], all float32 and contiguous."""
    global fwd_launches
    N, P = _check("point_sample_fwd_cuda", points, feat)
    if feat.dim() != 4 or feat.shape[0] != N:
        raise ValueError(f"point_sample_fwd_cuda: feat must be [N, H, W, C] with N = {N}, "
                         f"got {tuple(feat.shape)}")
    _, H, W, C = feat.shape
    _check_image("point_sample_fwd_cuda", N, H, W, C)
    out = torch.empty((N, P, C), dtype=torch.float32, device=feat.device)
    err = _kernel("point_sample_fwd")(feat.data_ptr(), points.data_ptr(), out.data_ptr(),
                                      N, H, W, C, P, _log2_group(C), _stream(feat))
    if err != 0:
        raise RuntimeError(f"point_sample_fwd launch failed: CUDA error {err}")
    fwd_launches += 1
    return out


def point_sample_dimg_cuda(points: torch.Tensor, grad_out: torch.Tensor,
                           image_hw) -> torch.Tensor:
    """Launch the image-gradient kernel: the gradient [N, H, W, C] of the
    forward's output against `grad_out` [N, P, C]."""
    global dimg_launches
    N, P = _check("point_sample_dimg_cuda", points, grad_out)
    H, W = (int(n) for n in image_hw)
    if grad_out.dim() != 3 or tuple(grad_out.shape[:2]) != (N, P):
        raise ValueError(f"point_sample_dimg_cuda: grad_out must be [{N}, {P}, C], got "
                         f"{tuple(grad_out.shape)}")
    C = grad_out.shape[2]
    _check_image("point_sample_dimg_cuda", N, H, W, C)
    dfeat = torch.zeros((N, H, W, C), dtype=torch.float32, device=grad_out.device)
    err = _kernel("point_sample_bwd_dimg")(points.data_ptr(), grad_out.data_ptr(),
                                           dfeat.data_ptr(), N, H, W, C, P, _log2_group(C),
                                           _stream(grad_out))
    if err != 0:
        raise RuntimeError(f"point_sample_bwd_dimg launch failed: CUDA error {err}")
    dimg_launches += 1
    return dfeat


def point_sample_dxy_cuda(feat: torch.Tensor, points: torch.Tensor,
                          grad_out: torch.Tensor) -> torch.Tensor:
    """Launch the point-gradient kernel: the gradient [N, P, 2] of the
    forward's output against `grad_out` [N, P, C]."""
    global dxy_launches
    N, P = _check("point_sample_dxy_cuda", points, feat, grad_out)
    if feat.dim() != 4 or feat.shape[0] != N or tuple(grad_out.shape) != (N, P, feat.shape[3]):
        raise ValueError(f"point_sample_dxy_cuda: feat {tuple(feat.shape)} and grad_out "
                         f"{tuple(grad_out.shape)} do not match points {tuple(points.shape)}")
    _, H, W, C = feat.shape
    _check_image("point_sample_dxy_cuda", N, H, W, C)
    dpoints = torch.empty((N, P, 2), dtype=torch.float32, device=feat.device)
    err = _kernel("point_sample_bwd_dxy")(feat.data_ptr(), points.data_ptr(),
                                          grad_out.data_ptr(), dpoints.data_ptr(),
                                          N, H, W, C, P, _log2_group(C), _stream(feat))
    if err != 0:
        raise RuntimeError(f"point_sample_bwd_dxy launch failed: CUDA error {err}")
    dxy_launches += 1
    return dpoints


class PointSampleFunction(torch.autograd.Function):
    """Forward kernel; backward through the image-gradient kernel and, when
    the points need a gradient, the point-gradient kernel."""

    @staticmethod
    def forward(ctx, feat, points):
        ctx.save_for_backward(feat, points)
        return point_sample_fwd_cuda(feat, points)

    @staticmethod
    def backward(ctx, grad_out):
        feat, points = ctx.saved_tensors
        g = grad_out.contiguous()
        dfeat = dpoints = None
        if ctx.needs_input_grad[0]:
            dfeat = point_sample_dimg_cuda(points, g, feat.shape[1:3])
        if ctx.needs_input_grad[1]:
            dpoints = point_sample_dxy_cuda(feat, points, g)
        return dfeat, dpoints


def point_sample_cuda(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """feat [N, H, W, C] at points [N, P, 2] in [0, 1] -> [N, P, C] on the
    card, differentiable in both inputs."""
    return PointSampleFunction.apply(feat, points)
