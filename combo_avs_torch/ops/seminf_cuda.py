"""Fused semantic inference on the card: the wrapper of
`csrc/seminf_fwd.cu` (the TPU's K7, `combo_avs_tpu/ops/seminf_pallas.py`)
and its plain PyTorch version.

`seminf_cuda(cls_sm [N, Q, C], mask [N, Q, h, w], out_size, temporal_mask)`
-> [N, C, H, W] float32 computes sum_q cls_sm * sigmoid(bilinear upsample of
mask) (times the per-frame temporal mask) without writing the [N, Q, H, W]
upsampled masks. It takes 1 <= C <= MAX_C and an upsampling `out_size`, and
raises on anything else; `models.meta_arch.semantic_inference` decides
which version runs.

bf16 masks: the plain version rounds the upsampled logits and the sigmoid to
bf16 before its float32 contraction; the kernel, like `seminf_pallas`,
interpolates and takes the sigmoid in float32 from the bf16 inputs. The two
therefore differ by those two roundings (each at most 2^-9 relative), which
`chip_smoke.py` bounds at 8e-3 of max |plain|.

`launches` counts the kernel's launches in this process, incremented where it
is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from combo_avs_torch.ops import _build

SOURCE = "seminf_fwd.cu"
MAX_C = 8  # one fp32 register per class in the kernel's loop

launches = 0


def _upcast32(x: torch.Tensor) -> torch.Tensor:
    """bf16 and fp16 to float32; float32 and float64 unchanged."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def semantic_inference_plain(cls_sm: torch.Tensor, mask: torch.Tensor,
                             out_size: Optional[Tuple[int, int]] = None,
                             temporal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_q cls_sm[n, q, c] * sigmoid(up(mask[n, q])) -> [N, C, H, W] in
    float32 (float64 for float64 inputs). The upsampled [N, Q, H, W] masks
    and their sigmoid stay in the mask's type (bf16 on the bf16 path); the
    contraction over queries is float32 or wider."""
    if out_size is not None:
        mask = F.interpolate(mask, size=tuple(out_size), mode="bilinear",
                             align_corners=False, antialias=False)
    N, Q, H, W = mask.shape
    sig = _upcast32(mask.sigmoid().reshape(N, Q, H * W))
    sem = torch.bmm(cls_sm.to(sig.dtype).transpose(1, 2), sig).reshape(N, -1, H, W)
    if temporal_mask is not None:
        sem = sem * temporal_mask.to(sem.dtype)[:, None, None, None]
    return sem


def kernel_takes(C: int, mask_hw: Tuple[int, int], out_size) -> bool:
    """Whether the kernel computes this call: few enough classes and an
    upsampling (or same-size) `out_size`."""
    return (out_size is not None and 1 <= C <= MAX_C
            and out_size[0] >= mask_hw[0] and out_size[1] >= mask_hw[1])


def _kernel():
    fn = _build.load(SOURCE).seminf_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def seminf_cuda(cls_sm: torch.Tensor, mask: torch.Tensor, out_size: Tuple[int, int],
                temporal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel: cls_sm [N, Q, C] (cast to float32), mask [N, Q, h,
    w] float32 or bfloat16, optional temporal_mask [N] -> [N, C, H, W]
    float32 at `out_size` (H, W) >= (h, w)."""
    global launches
    tensors = [cls_sm, mask] + ([temporal_mask] if temporal_mask is not None else [])
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("seminf_cuda: every input must be a CUDA tensor, all on one device")
    if mask.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"seminf_cuda: mask must be float32 or bfloat16, got {mask.dtype}")
    if mask.dim() != 4 or cls_sm.dim() != 3 or tuple(cls_sm.shape[:2]) != tuple(mask.shape[:2]):
        raise ValueError(f"seminf_cuda: cls_sm {tuple(cls_sm.shape)} must be [N, Q, C] and "
                         f"mask {tuple(mask.shape)} [N, Q, h, w]")
    N, Q, h, w = mask.shape
    C = cls_sm.shape[2]
    H, W = (int(s) for s in out_size)
    if not kernel_takes(C, (h, w), (H, W)):
        raise ValueError(f"seminf_cuda: takes 1 <= C <= {MAX_C} classes and an upsampling "
                         f"out_size; got C = {C}, mask {h}x{w} -> {H}x{W}")
    if Q * C * 4 > 48 * 1024 or N > 65535 or H * W >= 2**31:
        raise ValueError(f"seminf_cuda: shape N={N}, Q={Q}, C={C}, {H}x{W} is out of range")
    cls = cls_sm.to(torch.float32).contiguous()
    mask = mask.contiguous()
    scale = None
    if temporal_mask is not None:
        if tuple(temporal_mask.shape) != (N,):
            raise ValueError(f"seminf_cuda: temporal_mask must be [{N}], got "
                             f"{tuple(temporal_mask.shape)}")
        scale = temporal_mask.to(torch.float32).contiguous()
    out = torch.empty((N, C, H, W), dtype=torch.float32, device=mask.device)
    err = _kernel()(cls.data_ptr(), mask.data_ptr(), None if scale is None else scale.data_ptr(),
                    out.data_ptr(), N, Q, C, h, w, H, W, int(mask.dtype == torch.bfloat16),
                    torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seminf_fwd launch failed: CUDA error {err}")
    launches += 1
    return out
