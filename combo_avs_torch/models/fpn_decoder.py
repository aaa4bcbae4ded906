"""FPN pixel decoders, NCHW maps: the alternatives to the deformable one that
MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME selects.

Port of `combo_avs_tpu/models/fpn_decoder.py`:
* `BasePixelDecoder` (plain FPN): the lowest-resolution map takes a 3x3
  GN-ReLU output conv; every finer level adds a 1x1 GN lateral to the
  nearest-upsampled running map, then a 3x3 GN-ReLU output conv.
  `mask_features` is a 3x3 conv on the stride-4 map; the first 3 top-down
  maps are the multi-scale features.
* `TransformerEncoderPixelDecoder`: a 1x1 `input_proj` of res5, a post-norm
  transformer encoder over its pixels with sine positions, then the FPN with
  the encoder's map in place of res5 (its top output conv takes conv_dim
  channels). It has the JAX module's fixed settings: 6 layers, 8 heads, a
  2048-wide ReLU FFN (the JAX head passes it no others).
Nothing here launches a kernel: the JAX modules reach no Pallas call either.
Module names are the reference's (`adapter_{k}` / `layer_{k}` numbered from
res2 = 1, `mask_features`, `input_proj`, `transformer.encoder.layers.N`).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from combo_avs_torch.models.layers import Conv2d
from combo_avs_torch.models.position_encoding import sine_position_encoding
from combo_avs_torch.models.transformer_decoder import LN_EPS, MultiheadAttention

IN_FEATURES = ("res2", "res3", "res4", "res5")
GN_GROUPS, GN_EPS = 32, 1e-5


def _gn(dim: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, dim, eps=GN_EPS)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: self-attention with the positions on query
    and key, then a ReLU FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class BasePixelDecoder(nn.Module):
    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256, mask_dim: int = 256,
                 in_features: Sequence[str] = IN_FEATURES, top_channels: int = 0):
        """`top_channels`, when given, is the width of the lowest-resolution
        map instead of its backbone width (the transformer encoder's
        output)."""
        super().__init__()
        self.in_features = list(in_features)
        n = len(self.in_features)
        for idx, f in enumerate(self.in_features):
            if idx == n - 1:
                cin = top_channels or in_channels[f]
                self.add_module(f"layer_{idx + 1}", Conv2d(cin, conv_dim, 3, padding=1,
                                                           bias=False, norm=_gn(conv_dim)))
            else:
                self.add_module(f"adapter_{idx + 1}", Conv2d(in_channels[f], conv_dim, 1,
                                                             bias=False, norm=_gn(conv_dim)))
                self.add_module(f"layer_{idx + 1}", Conv2d(conv_dim, conv_dim, 3, padding=1,
                                                           bias=False, norm=_gn(conv_dim)))
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 3, padding=1)

    def fpn(self, features: Dict[str, torch.Tensor]):
        n = len(self.in_features)
        outs, y = [], None
        for idx, f in enumerate(self.in_features[::-1]):  # res5 -> res2
            x, k = features[f], n - idx
            if y is None:
                y = F.relu(getattr(self, f"layer_{k}")(x))
            else:
                # "nearest-exact" is jax.image.resize's nearest: the source
                # pixel under each output pixel's centre
                up = F.interpolate(y, size=x.shape[-2:], mode="nearest-exact")
                y = F.relu(getattr(self, f"layer_{k}")(getattr(self, f"adapter_{k}")(x) + up))
            outs.append(y)
        return self.mask_features(outs[-1]), outs[:3]

    def forward(self, features: Dict[str, torch.Tensor]):
        mask_features, multi_scale = self.fpn(features)
        return mask_features, None, multi_scale


class _EncoderStack(nn.Module):
    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _EncoderOnly(nn.Module):
    """Holds the encoder layers under the reference's
    `transformer.encoder.layers.N` keys."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.encoder = _EncoderStack(layers)


class TransformerEncoderPixelDecoder(BasePixelDecoder):
    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256, mask_dim: int = 256,
                 in_features: Sequence[str] = IN_FEATURES, nheads: int = 8,
                 dim_feedforward: int = 2048, enc_layers: int = 6):
        super().__init__(in_channels, conv_dim, mask_dim, in_features, top_channels=conv_dim)
        self.conv_dim = conv_dim
        self.input_proj = nn.Conv2d(in_channels[self.in_features[-1]], conv_dim, 1)
        self.transformer = _EncoderOnly([TransformerEncoderLayer(conv_dim, nheads,
                                                                 dim_feedforward)
                                         for _ in range(enc_layers)])

    def forward(self, features: Dict[str, torch.Tensor]):
        top = self.in_features[-1]
        x = self.input_proj(features[top])
        B, C, H, W = x.shape
        src = x.flatten(2).transpose(1, 2)
        pe = sine_position_encoding(H, W, self.conv_dim // 2).reshape(1, H * W, -1)
        pos = torch.from_numpy(pe).to(src.device, src.dtype)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos)
        encoded = src.transpose(1, 2).reshape(B, C, H, W)
        mask_features, multi_scale = self.fpn({**features, top: encoded})
        return mask_features, encoded, multi_scale


PIXEL_DECODERS = {"BasePixelDecoder": BasePixelDecoder,
                  "TransformerEncoderPixelDecoder": TransformerEncoderPixelDecoder}
