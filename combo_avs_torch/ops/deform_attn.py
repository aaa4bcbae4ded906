"""Multi-scale deformable attention: the plain PyTorch version.

Same function as `combo_avs_tpu/ops/deform_attn.py::ms_deform_attn` (the
4-corner gather form of the reference's `grid_sample` oracle): per level,
bilinearly sample the head-split values at `loc * (W, H) - 0.5` with zero
padding outside the level (grid_sample, align_corners=False), then reduce
with the attention weights over levels x points. It is the CPU path of
`ops.deform_attn_cuda.ms_deform_attn` and the oracle its CUDA kernel is held
against.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def ms_deform_attn_plain(
    value: torch.Tensor,  # [B, S, M, D], S = sum(H_l * W_l)
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, M, L, P, 2] in [0, 1], (x, y)
    attention_weights: torch.Tensor,  # [B, Lq, M, L, P]
) -> torch.Tensor:
    """Returns [B, Lq, M * D] in value's dtype; sums run in the promoted type
    of value and the locations (fp32 for bf16 value)."""
    B, S, M, D = value.shape
    _, Lq, Mq, L, P, _ = sampling_locations.shape
    if Mq != M or L != len(spatial_shapes):
        raise ValueError(f"heads/levels mismatch: value {tuple(value.shape)}, "
                         f"locations {tuple(sampling_locations.shape)}, shapes {spatial_shapes}")
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value length {S} != sum of spatial shapes {spatial_shapes}")

    out = None
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        # [B, HW, M, D] -> [B*M, HW, D]: one flat gather axis per (frame, head)
        v = value[:, start : start + H * W].permute(0, 2, 1, 3).reshape(B * M, H * W, D)
        start += H * W

        loc = sampling_locations[:, :, :, lvl]  # [B, Lq, M, P, 2]
        x = (loc[..., 0] * W - 0.5).permute(0, 2, 1, 3).reshape(B * M, Lq * P)
        y = (loc[..., 1] * H - 0.5).permute(0, 2, 1, 3).reshape(B * M, Lq * P)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wy1 = y - y0
        x0i = x0.long()
        y0i = y0.long()

        def corner(xi, yi, w, v=v, H=H, W=W):
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            g = torch.gather(v, 1, idx[..., None].expand(-1, -1, D))  # [B*M, Lq*P, D]
            return g * (w * valid)[..., None]

        sampled = (
            corner(x0i, y0i, (1 - wx1) * (1 - wy1))
            + corner(x0i + 1, y0i, wx1 * (1 - wy1))
            + corner(x0i, y0i + 1, (1 - wx1) * wy1)
            + corner(x0i + 1, y0i + 1, wx1 * wy1)
        ).reshape(B, M, Lq, P, D)
        w_l = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).to(sampled.dtype)
        term = torch.einsum("bmqpd,bmqp->bqmd", sampled, w_l)
        out = term if out is None else out + term

    return out.reshape(B, Lq, M * D).to(value.dtype)
