"""Multi-scale deformable-attention pixel decoder, NCHW maps.

Port of `combo_avs_tpu/models/pixel_decoder.py`:
* 1x1 projections + GroupNorm(32) of [res5, res4, res3] (top-down order),
* a deformable-DETR encoder (post-norm, ReLU FFN of 1024, n_heads x 4 points
  x 3 levels) over the flattened multi-scale tokens, run as a plain loop over
  its layers,
* the tokens split back into maps, one FPN step down to stride 4 (lateral
  1x1 + GN on res2, bilinear-upsampled add, 3x3 GN ReLU conv),
* a 1x1 `mask_features` conv.
Returns (mask_features [B, mask_dim, H/4, W/4], encoder res5 map, the 3
multi-scale maps coarse -> fine). Module names follow the reference
checkpoints (`input_proj.0.0`, `transformer.encoder.layers.0.self_attn`,
`adapter_1`, `layer_1`), which `combo_avs_tpu/train/checkpoint.py::
convert_pixel_decoder` reads.

Inputs are never padded, so valid ratios are identically one and the
reference points are a numpy float32 constant, as on the JAX side.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from combo_avs_torch.models.layers import Conv2d, init_xavier
from combo_avs_torch.models.position_encoding import sine_position_encoding
from combo_avs_torch.ops.deform_attn_cuda import ms_deform_attn

# flax LayerNorm's default epsilon, which the JAX package uses here
LN_EPS = 1e-6
TRANSFORMER_IN_FEATURES = ("res3", "res4", "res5")
D_FFN = 1024  # hardcoded in the reference
N_POINTS = 4


def directional_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Bias of the sampling-offset linear: a ring of unit directions per head,
    radius growing with the point index. float64, [M * L * P * 2]."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Deformable attention module; the sampling core is K1 on CUDA."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    @torch.no_grad()
    def init_params(self, g):
        init_xavier(self.value_proj, g)
        init_xavier(self.output_proj, g)
        self.sampling_offsets.weight.zero_()
        bias = directional_offset_bias(self.n_heads, self.n_levels, self.n_points)
        self.sampling_offsets.bias.copy_(torch.from_numpy(bias))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(
        self,
        query: torch.Tensor,  # [B, Lq, C]
        reference_points: torch.Tensor,  # [Lq, L, 2] in [0, 1], float32
        value_src: torch.Tensor,  # [B, S, C]
        spatial_shapes: Tuple[Tuple[int, int], ...],
    ) -> torch.Tensor:
        B, Lq, _ = query.shape
        L, M, P = self.n_levels, self.n_heads, self.n_points
        value = self.value_proj(value_src).reshape(B, -1, M, self.d_model // M)
        offsets = self.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
        weights = self.attention_weights(query).reshape(B, Lq, M, L * P)
        weights = weights.softmax(-1).reshape(B, Lq, M, L, P)
        # offsets are normalized by (W, H) per level; the float32 normalizer
        # and reference points promote a bf16 offset to float32, as in JAX
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                                  device=query.device)
        loc = (reference_points[None, :, None, :, None, :]
               + offsets / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn(value.contiguous(), spatial_shapes, loc, weights)
        return self.output_proj(out)


class DeformableEncoderLayer(nn.Module):
    """Post-norm deformable self-attention + ReLU FFN."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, reference_points, spatial_shapes):
        src = self.norm1(src + self.self_attn(src + pos, reference_points, src, spatial_shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


@functools.lru_cache(maxsize=None)
def encoder_reference_points(spatial_shapes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """Pixel-centre reference points, [S, L, 2] float32 (valid ratios are one
    for unpadded inputs). Cached: treat the result as read-only."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, axis=0)  # [S, 2]
    return np.broadcast_to(ref[:, None, :], (ref.shape[0], len(spatial_shapes), 2)).copy()


class _EncoderStack(nn.Module):
    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Transformer(nn.Module):
    """Holds the level embedding and the encoder under the reference's
    `transformer.level_embed` / `transformer.encoder.layers.N` keys."""

    def __init__(self, n_levels: int, d_model: int, layers: Sequence[nn.Module]):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(n_levels, d_model))
        self.encoder = _EncoderStack(layers)

    @torch.no_grad()
    def init_params(self, g):
        self.level_embed.normal_(0.0, 1.0, generator=g)


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(
        self,
        in_channels: Dict[str, int],  # {"res2": 256, ..., "res5": 2048}
        conv_dim: int = 256,
        mask_dim: int = 256,
        enc_layers: int = 6,
        n_heads: int = 8,
    ):
        super().__init__()
        # top-down order: lowest resolution first
        self.tif = list(TRANSFORMER_IN_FEATURES)[::-1]
        self.conv_dim = conv_dim
        L = len(self.tif)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(in_channels[f], conv_dim, 1), nn.GroupNorm(32, conv_dim, eps=1e-5))
            for f in self.tif
        )
        self.transformer = _Transformer(L, conv_dim, [
            DeformableEncoderLayer(conv_dim, D_FFN, L, n_heads, N_POINTS) for _ in range(enc_layers)
        ])
        # one FPN step: stride 8 (res3, the finest transformer level) -> stride 4 (res2)
        self.adapter_1 = Conv2d(in_channels["res2"], conv_dim, 1, bias=False,
                                norm=nn.GroupNorm(32, conv_dim, eps=1e-5))
        self.layer_1 = Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False,
                              norm=nn.GroupNorm(32, conv_dim, eps=1e-5))
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    @torch.no_grad()
    def init_params(self, g):
        for proj in self.input_proj:
            init_xavier(proj[0], g)
        for conv in (self.adapter_1, self.layer_1, self.mask_features):
            init_xavier(conv, g)

    def forward(self, features: Dict[str, torch.Tensor]):
        srcs, poss, shapes = [], [], []
        level_embed = self.transformer.level_embed
        for idx, f in enumerate(self.tif):
            x = self.input_proj[idx](features[f])
            B, C, H, W = x.shape
            srcs.append(x.flatten(2).transpose(1, 2))  # [B, HW, C]
            pe = torch.from_numpy(sine_position_encoding(H, W, C // 2).reshape(1, H * W, C))
            poss.append(pe.to(x.device, x.dtype) + level_embed[idx][None, None, :])
            shapes.append((H, W))
        spatial_shapes = tuple(shapes)
        src = torch.cat(srcs, 1)
        pos = torch.cat(poss, 1)
        ref = torch.from_numpy(encoder_reference_points(spatial_shapes)).to(src.device)

        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, ref, spatial_shapes)

        out = []
        start = 0
        for H, W in spatial_shapes:
            out.append(src[:, start : start + H * W].transpose(1, 2).reshape(-1, self.conv_dim, H, W))
            start += H * W

        x = features["res2"]
        lat = self.adapter_1(x)
        up = F.interpolate(out[-1], size=x.shape[-2:], mode="bilinear",
                           align_corners=False, antialias=False)
        out.append(F.relu(self.layer_1(lat + up)))

        return self.mask_features(out[-1]), out[0], out[:3]
