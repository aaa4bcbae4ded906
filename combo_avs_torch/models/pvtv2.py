"""PVTv2 visual backbone, the B5 of COMBO-PVTv2-B5, NCHW in and out.

Port of `combo_avs_tpu/models/pvtv2.py` (ref: models/modeling/backbone/
pvtv2.py:17-409): four stages, each an overlapping patch embedding (7x7
stride 4 pad 3, then 3x3 stride 2 pad 1, with a LayerNorm) and a stack of
pre-norm blocks: spatial-reduction attention (keys and values from the
tokens downsampled by an sr x sr stride-sr conv and a LayerNorm where sr > 1)
and an MLP with a 3x3 depthwise conv between its two Linears, exact (erf)
GELU. Stochastic depth decays linearly from 0 to 0.1 over all blocks in
order. B5: widths 64/128/320/512, heads 1/2/5/8, depths 3/6/40/3,
sr 8/4/2/1, MLP ratio 4, qkv bias, LayerNorm eps 1e-6 (as the JAX package
and timm).

Each stage is an `nn.ModuleList` of blocks (the JAX package scans one block
over a stacked depth axis); nothing is recomputed in the backward (the JAX
package remats each block to fit a 16 GB TPU). Parameter names are timm's
(`patch_embed1.proj`, `block1.0.attn.q`, `block1.0.attn.sr`,
`block1.0.mlp.dwconv.dwconv`, `norm1`, ...), which
`combo_avs_tpu/train/checkpoint.py::convert_pvt` and the reference's
`d2_pvt_v2_b5.pkl` use. The attention is the plain matmul -> softmax ->
matmul the JAX package computes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from combo_avs_torch.models.layers import DropPath

LN_EPS = 1e-6
# B5 (ref: pvtv2.py:391-409), the one PVTv2 the configs name
B5_DEPTHS = (3, 6, 40, 3)
EMBED_DIMS, NUM_HEADS, SR_RATIOS = (64, 128, 320, 512), (1, 2, 5, 8), (8, 4, 2, 1)
MLP_RATIO, DROP_PATH_RATE = 4, 0.1


class SRAttention(nn.Module):
    """Spatial-reduction attention over [B, N, C] tokens of an H x W map."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        q = self.q(x).reshape(B, N, self.num_heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            xm = self.sr(x.transpose(1, 2).reshape(B, C, H, W))
            kv_in = self.norm(xm.flatten(2).transpose(1, 2))
        kv = self.kv(kv_in).reshape(B, -1, 2, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q @ kv[0].transpose(-2, -1)) * hd ** -0.5
        out = attn.softmax(-1) @ kv[1]
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class DWConv(nn.Module):
    """The 3x3 depthwise conv of the MLP, over [B, N, C] tokens of an H x W
    map (its own module for timm's `mlp.dwconv.dwconv` name)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        return self.dwconv(x.transpose(1, 2).reshape(B, C, H, W)).flatten(2).transpose(1, 2)


class ConvMlp(nn.Module):
    """fc1 -> 3x3 depthwise conv -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), H, W)))


class PVTBlock(nn.Module):
    """x + DropPath(attn(norm1(x))), then x + DropPath(mlp(norm2(x))), both
    branches at the block's own rate."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = ConvMlp(dim, dim * mlp_ratio)
        self.drop_path = DropPath()

    def forward(self, x: torch.Tensor, H: int, W: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        r = self.drop_path_rate
        x = x + self.drop_path(self.attn(self.norm1(x), H, W), r, generator)
        return x + self.drop_path(self.mlp(self.norm2(x), H, W), r, generator)


class PatchEmbed(nn.Module):
    """Overlapping patch embedding: a strided conv, then a LayerNorm over the
    [B, N, C] tokens."""

    def __init__(self, cin: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride=stride, padding=patch // 2)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        _, _, H, W = x.shape
        return self.norm(x.flatten(2).transpose(1, 2)), H, W


class PVTv2(nn.Module):
    """PVTv2-B5: [B, 3, H, W] -> {"res2": [B, 64, H/4, W/4], ..., "res5":
    [B, 512, H/32, W/32]}; `depths` cuts the stages for tests. In training
    mode each block's residual branches drop whole samples, drawn from the
    `generator` that `forward` is given."""

    def __init__(self, depths: Sequence[int] = B5_DEPTHS):
        super().__init__()
        self.depths = tuple(depths)
        rates = np.linspace(0, DROP_PATH_RATE, sum(self.depths)).tolist()
        cin = 3
        for i, dim in enumerate(EMBED_DIMS):
            patch, stride = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"patch_embed{i + 1}", PatchEmbed(cin, dim, patch, stride))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                PVTBlock(dim, NUM_HEADS[i], SR_RATIOS[i], MLP_RATIO, r)
                for r in rates[sum(self.depths[:i]):sum(self.depths[:i + 1])]))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(dim, eps=LN_EPS))
            cin = dim

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        B = x.shape[0]
        outputs = {}
        for i in range(len(self.depths)):
            x, H, W = getattr(self, f"patch_embed{i + 1}")(x)
            for block in getattr(self, f"block{i + 1}"):
                x = block(x, H, W, generator)
            x = getattr(self, f"norm{i + 1}")(x)
            x = x.transpose(1, 2).reshape(B, -1, H, W)
            outputs[f"res{i + 2}"] = x
        return outputs
