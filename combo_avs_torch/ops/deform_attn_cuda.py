"""Multi-scale deformable attention on the card: the wrappers of the K1
forward and K2 backward kernels, their `torch.autograd.Function`, and the
device dispatch.

`ms_deform_attn` is what the model calls. A CUDA tensor goes through
`MSDeformAttnFunction`, whose forward launches `csrc/ms_deform_attn_fwd.cu` and whose
backward launches `csrc/ms_deform_attn_bwd.cu` (or raise); a CPU tensor takes
the plain version `ops.deform_attn.ms_deform_attn_plain`, differentiated by
autograd. There is no fallback from one to the other.

`launches` and `bwd_launches` count the two kernels' launches in this
process: each is incremented where its kernel is launched and nowhere else,
so a caller can reset them, run the model, and see that the path went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from combo_avs_torch.ops import _build
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

SOURCE = "ms_deform_attn_fwd.cu"
BWD_SOURCE = "ms_deform_attn_bwd.cu"
MAX_LEVELS = 4

launches = 0
bwd_launches = 0


def _fwd_kernel():
    fn = _build.load(SOURCE).ms_deform_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel():
    fn = _build.load(BWD_SOURCE).ms_deform_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(value, spatial_shapes, sampling_locations, attention_weights, name):
    """Validate what both kernels take; returns the level shapes as ints."""
    tensors = (value, sampling_locations, attention_weights)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: every input must be a CUDA tensor")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs lie on different devices")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: value must be float32 or bfloat16, got {value.dtype}")
    if value.dim() != 4 or sampling_locations.dim() != 6 or attention_weights.dim() != 5:
        raise ValueError(f"{name}: expected value [B,S,M,D], locations "
                         "[B,Lq,M,L,P,2], weights [B,Lq,M,L,P]")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if (sampling_locations.shape[0] != B or sampling_locations.shape[2] != M
            or sampling_locations.shape[-1] != 2
            or tuple(attention_weights.shape) != (B, Lq, M, L, P)):
        raise ValueError(f"{name}: shapes disagree: value {tuple(value.shape)}, "
                         f"locations {tuple(sampling_locations.shape)}, "
                         f"weights {tuple(attention_weights.shape)}")
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if len(shapes) != L or not 1 <= L <= MAX_LEVELS or L * P > 32:
        raise ValueError(f"{name}: takes 1..{MAX_LEVELS} levels with "
                         f"levels*points <= 32, got shapes {shapes} and P={P}")
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"{name}: value length {S} != sum of spatial shapes {shapes}")
    if not value.is_contiguous():
        raise ValueError(f"{name}: value must be contiguous")
    if B * S * M * D >= 2**31 or B * Lq * M * L * P * 2 >= 2**31:
        raise ValueError(f"{name}: tensors too large for 32-bit row indices")
    return shapes


def _levels(shapes):
    return (ctypes.c_int * (2 * len(shapes)))(*[n for hw in shapes for n in hw])


def ms_deform_attn_cuda(
    value: torch.Tensor,  # [B, S, M, D] fp32 or bf16, CUDA, contiguous
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, M, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Lq, M, L, P]
) -> torch.Tensor:
    """Launch K1; returns [B, Lq, M * D] in value's dtype. Not differentiable
    by itself: `MSDeformAttnFunction` pairs it with K2."""
    global launches
    shapes = _check(value, spatial_shapes, sampling_locations, attention_weights,
                    "ms_deform_attn_cuda")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    # the kernel reads fp32 locations and weights (the TPU path promotes them too)
    loc = sampling_locations.detach().to(torch.float32).contiguous()
    attw = attention_weights.detach().to(torch.float32).contiguous()
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = _fwd_kernel()(value.data_ptr(), loc.data_ptr(), attw.data_ptr(), out.data_ptr(),
                        1 if value.dtype == torch.bfloat16 else 0, B, S, Lq, M, D, L, P,
                        _levels(shapes), stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_fwd launch failed: CUDA error {err}")
    launches += 1
    return out


def ms_deform_attn_bwd_cuda(value, spatial_shapes, sampling_locations, attention_weights,
                            grad_out):
    """Launch K2: the gradients (dvalue, dlocations, dweights) of K1's output
    against `grad_out` [B, Lq, M * D], in the inputs' dtypes. fp32 value only
    (the bf16 training regime, AMP, is not ported yet)."""
    global bwd_launches
    shapes = _check(value, spatial_shapes, sampling_locations, attention_weights,
                    "ms_deform_attn_bwd_cuda")
    if value.dtype != torch.float32:
        raise TypeError("ms_deform_attn_bwd_cuda: the backward takes a float32 value only, "
                        f"got {value.dtype}")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if tuple(grad_out.shape) != (B, Lq, M * D) or grad_out.device != value.device:
        raise ValueError(f"ms_deform_attn_bwd_cuda: grad_out {tuple(grad_out.shape)} on "
                         f"{grad_out.device}, expected {(B, Lq, M * D)} on {value.device}")
    loc = sampling_locations.detach().to(torch.float32).contiguous()
    attw = attention_weights.detach().to(torch.float32).contiguous()
    g = grad_out.detach().to(torch.float32).contiguous()
    dvalue = torch.zeros_like(value, dtype=torch.float32)
    dloc = torch.empty_like(loc)
    dattw = torch.empty_like(attw)
    if g.numel() and dvalue.numel():
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = _bwd_kernel()(value.data_ptr(), loc.data_ptr(), attw.data_ptr(), g.data_ptr(),
                            dvalue.data_ptr(), dloc.data_ptr(), dattw.data_ptr(),
                            B, S, Lq, M, D, L, P, _levels(shapes), stream)
        if err != 0:
            raise RuntimeError(f"ms_deform_attn_bwd launch failed: CUDA error {err}")
        bwd_launches += 1
    else:
        dloc.zero_()
        dattw.zero_()
    return (dvalue, dloc.to(sampling_locations.dtype),
            dattw.to(attention_weights.dtype))


class MSDeformAttnFunction(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = tuple(spatial_shapes)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attw = ctx.saved_tensors
        dvalue, dloc, dattw = ms_deform_attn_bwd_cuda(value, ctx.spatial_shapes, loc, attw,
                                                      grad_out)
        return dvalue, None, dloc, dattw


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """Device dispatch: K1 (and K2 for its gradient) for a CUDA value, the
    plain version for a CPU one."""
    if not value.is_cuda:
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    if (value.dtype != torch.float32 and torch.is_grad_enabled()
            and any(t.requires_grad for t in (value, sampling_locations, attention_weights))):
        raise TypeError("ms_deform_attn: gradients on the card take a float32 value only "
                        f"(got {value.dtype}); the bf16 training regime is not ported yet")
    return MSDeformAttnFunction.apply(value, spatial_shapes, sampling_locations, attention_weights)
