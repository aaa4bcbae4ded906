"""Bilateral audio-visual fusion (MHA-B) and the audio transformation MLP.

Port of the late-fusion path of `combo_avs_tpu/models/fusion.py`:
* `BiMultiHeadAttention`: one logit matrix (vision queries [B, N, C] x the
  single audio key) used both ways: a softmax over the spatial axis scales
  the audio value into every pixel, and a max-normalized softmax over the
  same axis pools the vision values into a new audio vector;
* `BiAttentionBlock`: per-level pre-LayerNorms + BiMHA with LayerScale
  residuals on the post-norm features; audio outputs averaged over levels;
* `AVFuse` (MHA-B; the other fusion types are not ported yet): learned audio position embedding, sine image
  positions and a level embedding around `BiAttentionBlock`;
* `AudioMLP`: 128 -> 4096 -> 4096 -> out.
Module names follow the reference checkpoints, which
`combo_avs_tpu/train/checkpoint.py::convert_fusion` / `convert_audio_mlp` read.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from combo_avs_torch.models.layers import init_xavier
from combo_avs_torch.models.position_encoding import sine_position_encoding

CLAMP = 50000.0
LN_EPS = 1e-6  # flax LayerNorm's default, as in the JAX package
GAMMA_INIT = 1e-4  # LayerScale init of the fusion residuals
DROPOUT = 0.1  # on both attention maps in training mode (fusion.py:88-90 of the JAX package)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a mask drawn from `generator` (never from the
    global RNG): keep with probability 1 - rate, scale kept values by
    1 / (1 - rate), as flax's `nn.Dropout`."""
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, a_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.a_proj = nn.Linear(a_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_a_proj = nn.Linear(a_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_a_proj = nn.Linear(embed_dim, a_dim)

    def init_params(self, g):
        for lin in (self.v_proj, self.a_proj, self.values_v_proj, self.values_a_proj,
                    self.out_v_proj, self.out_a_proj):
            init_xavier(lin, g)

    def forward(self, v, a, pos_v: Optional[torch.Tensor] = None,
                pos_a: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """v [B, N, v_dim], a [B, 1, a_dim] -> (dv [B, N, v_dim], da [B, 1, a_dim]).
        In training mode both attention maps take dropout, drawn from
        `generator`."""
        B, N, _ = v.shape
        M = self.num_heads
        hd = self.embed_dim // M
        q = self.v_proj(v if pos_v is None else v + pos_v) * hd**-0.5
        k = self.a_proj(a if pos_a is None else a + pos_a)
        val_v = self.values_v_proj(v).reshape(B, N, M, hd)
        val_a = self.values_a_proj(a).reshape(B, M, hd)

        logits = torch.einsum("bnmd,bmd->bmn", q.reshape(B, N, M, hd), k.reshape(B, M, hd))
        logits = logits.clamp(-CLAMP, CLAMP)
        # audio->vision: softmax over the spatial axis
        attn_v = logits.softmax(-1)
        # vision->audio: max-normalized softmax over the same axis
        attn_a = (logits - logits.amax(-1, keepdim=True)).softmax(-1)
        if self.training:
            attn_v = dropout(attn_v, DROPOUT, generator)
            attn_a = dropout(attn_a, DROPOUT, generator)

        out_v = torch.einsum("bmn,bmd->bnmd", attn_v, val_a).reshape(B, N, self.embed_dim)
        out_a = torch.einsum("bmn,bnmd->bmd", attn_a, val_v).reshape(B, 1, self.embed_dim)
        return self.out_v_proj(out_v), self.out_a_proj(out_a)


class BiAttentionBlock(nn.Module):
    def __init__(self, vision_dims: Sequence[int], audio_dim: int, embed_dim: int,
                 num_heads: int):
        super().__init__()
        self.layer_norm_v_list = nn.ModuleList(nn.LayerNorm(d, eps=LN_EPS) for d in vision_dims)
        self.layer_norm_a_list = nn.ModuleList(nn.LayerNorm(audio_dim, eps=LN_EPS) for _ in vision_dims)
        self.attn_list = nn.ModuleList(
            BiMultiHeadAttention(d, audio_dim, embed_dim, num_heads) for d in vision_dims)
        self.gamma_v_list = nn.ParameterList(nn.Parameter(torch.empty(d)) for d in vision_dims)
        self.gamma_a = nn.Parameter(torch.empty(audio_dim))

    @torch.no_grad()
    def init_params(self, g):
        for p in (*self.gamma_v_list, self.gamma_a):
            p.fill_(GAMMA_INIT)

    def forward(self, visual: Sequence[torch.Tensor], audio, pos_v=None, pos_a=None,
                generator: Optional[torch.Generator] = None):
        """visual: per-level [B, C, H, W] maps; audio [B, 1, a_dim] ->
        (fused maps, fused audio [B, 1, a_dim])."""
        out, new_a = [], []
        for lvl, feat in enumerate(visual):
            B, C, H, W = feat.shape
            v = self.layer_norm_v_list[lvl](feat.flatten(2).transpose(1, 2))  # [B, HW, C]
            a = self.layer_norm_a_list[lvl](audio)
            dv, da = self.attn_list[lvl](v, a, pos_v, pos_a, generator)
            # residuals attach to the post-LayerNorm features
            v = v + self.gamma_v_list[lvl] * dv
            new_a.append(a + self.gamma_a * da)
            out.append(v.transpose(1, 2).reshape(B, C, H, W))
        return out, torch.stack(new_a, 1).mean(1)


class AVFuse(nn.Module):
    """MHA-B fusion of `fused_backbone` maps with the audio vector; returns
    ({name: fused [B, C, H, W]}, audio [B, 1, audio_dim])."""

    def __init__(self, audio_dim: int, fused_backbone: Sequence[str],
                 fused_backbone_dim: Sequence[int]):
        super().__init__()
        self.fused_backbone = list(fused_backbone)
        self.pos_dim = fused_backbone_dim[0]
        self.audio_pos = nn.Embedding(1, audio_dim)
        self.level_embed = nn.Embedding(1, fused_backbone_dim[0])
        self.b_attn = BiAttentionBlock(fused_backbone_dim, audio_dim, max(fused_backbone_dim), 8)

    @torch.no_grad()
    def init_params(self, g):
        self.audio_pos.weight.normal_(0.0, 1.0, generator=g)
        self.level_embed.weight.normal_(0.0, 1.0, generator=g)

    def forward(self, visual_features: Dict[str, torch.Tensor], audio: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        feats = []
        image_pos = None
        for i, name in enumerate(self.fused_backbone):
            f = visual_features[name]
            _, _, H, W = f.shape
            pe = sine_position_encoding(H, W, self.pos_dim // 2).reshape(1, H * W, -1)
            image_pos = torch.from_numpy(pe).to(f.device, f.dtype)
            feats.append(f + self.level_embed.weight[i][None, :, None, None])
        pos_a = self.audio_pos.weight[None].expand(audio.shape[0], 1, -1)
        fused, audio = self.b_attn(feats, audio, pos_v=image_pos, pos_a=pos_a,
                                   generator=generator)
        out = dict(visual_features)
        out.update(zip(self.fused_backbone, fused))
        return out, audio


class AudioMLP(nn.Module):
    """128 -> 4096 -> 4096 -> out_dim, ReLU between."""

    def __init__(self, out_dim: int, in_dim: int = 128, hidden: int = 4096):
        super().__init__()
        self.embeddings = nn.Sequential(
            nn.Linear(in_dim, hidden), nn.ReLU(),
            nn.Linear(hidden, hidden), nn.ReLU(),
            nn.Linear(hidden, out_dim),
        )

    def forward(self, x):
        return self.embeddings(x)
