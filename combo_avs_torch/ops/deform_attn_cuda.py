"""Multi-scale deformable attention on the card: the K1 kernel's wrapper and
the device dispatch.

`ms_deform_attn` is what the model calls. A CUDA tensor launches the
hand-written kernel `csrc/ms_deform_attn_fwd.cu` (or raises); a CPU tensor
takes the plain version `ops.deform_attn.ms_deform_attn_plain`. There is no
fallback from one to the other.

`launches` counts the kernel's launches in this process: it is incremented
where the kernel is launched and nowhere else, so a caller can reset it, run
the model, and see that the path went through the kernel.

Forward only: the backward (the TPU's K2) comes with the training slice, so
on CUDA the wrapper refuses inputs that require grad while grad is enabled.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from combo_avs_torch.ops import _build
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

SOURCE = "ms_deform_attn_fwd.cu"
MAX_LEVELS = 4

launches = 0


def _kernel():
    lib = _build.load(SOURCE)
    fn = lib.ms_deform_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ms_deform_attn_cuda(
    value: torch.Tensor,  # [B, S, M, D] fp32 or bf16, CUDA, contiguous
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, M, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Lq, M, L, P]
) -> torch.Tensor:
    """Launch K1; returns [B, Lq, M * D] in value's dtype."""
    global launches
    tensors = (value, sampling_locations, attention_weights)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ms_deform_attn_cuda: every input must be a CUDA tensor")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ms_deform_attn_cuda: inputs lie on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ms_deform_attn_cuda is forward-only: run under "
                           "torch.inference_mode() or torch.no_grad()")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ms_deform_attn_cuda: value must be float32 or bfloat16, got {value.dtype}")
    if value.dim() != 4 or sampling_locations.dim() != 6 or attention_weights.dim() != 5:
        raise ValueError("ms_deform_attn_cuda: expected value [B,S,M,D], locations "
                         "[B,Lq,M,L,P,2], weights [B,Lq,M,L,P]")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if (sampling_locations.shape[0] != B or sampling_locations.shape[2] != M
            or sampling_locations.shape[-1] != 2
            or tuple(attention_weights.shape) != (B, Lq, M, L, P)):
        raise ValueError(f"ms_deform_attn_cuda: shapes disagree: value {tuple(value.shape)}, "
                         f"locations {tuple(sampling_locations.shape)}, "
                         f"weights {tuple(attention_weights.shape)}")
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if len(shapes) != L or not 1 <= L <= MAX_LEVELS or L * P > 32:
        raise ValueError(f"ms_deform_attn_cuda: takes 1..{MAX_LEVELS} levels with "
                         f"levels*points <= 32, got shapes {shapes} and P={P}")
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"ms_deform_attn_cuda: value length {S} != sum of spatial shapes {shapes}")
    if not value.is_contiguous():
        raise ValueError("ms_deform_attn_cuda: value must be contiguous")
    if B * S * M * D >= 2**31 or B * Lq * M * L * P * 2 >= 2**31:
        raise ValueError("ms_deform_attn_cuda: tensors too large for 32-bit row indices")
    # the kernel reads fp32 locations and weights (the TPU path promotes them too)
    loc = sampling_locations.to(torch.float32).contiguous()
    attw = attention_weights.to(torch.float32).contiguous()
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    hw = (ctypes.c_int * (2 * L))(*[n for hw in shapes for n in hw])
    fn = _kernel()
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = fn(value.data_ptr(), loc.data_ptr(), attw.data_ptr(), out.data_ptr(),
             1 if value.dtype == torch.bfloat16 else 0, B, S, Lq, M, D, L, P, hw, stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_fwd launch failed: CUDA error {err}")
    launches += 1
    return out


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """Device dispatch: K1 for a CUDA value, the plain version for a CPU one."""
    if value.is_cuda:
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations, attention_weights)
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
