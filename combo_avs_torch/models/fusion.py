"""Audio-visual fusion (MHA-B, MHA-S, MHA-S-Audio, MHA-None) and the audio
transformation MLP.

Port of `combo_avs_tpu/models/fusion.py`:
* `BiMultiHeadAttention`: one logit matrix (vision queries [B, N, C] x the
  single audio key) used both ways: a softmax over the spatial axis scales
  the audio value into every pixel, and a max-normalized softmax over the
  same axis pools the vision values into a new audio vector;
* `BiAttentionBlock`: per-level pre-LayerNorms + BiMHA with LayerScale
  residuals on the post-norm features; audio outputs averaged over levels;
* `CrossAttention` / `AttentionA2I`: the single-direction audio -> image
  block of MHA-S (per-level pre-LayerNorms, a clamped cross-attention from
  the pixels to the audio vector, LayerScale residual `gamma`);
* `AVFuse`: a level embedding on each fused map, then by type: MHA-B the
  bilateral block with a learned audio position embedding and sine image
  positions; MHA-S-Audio the same block, keeping only its audio output;
  MHA-S the audio -> image block, audio unchanged; MHA-None nothing more;
* `AudioMLP`: 128 -> 4096 -> 4096 -> out;
* `FeatureResizer`, `l1norm`, `l2norm`, `func_attention`: the SCAN-era
  helpers the JAX module keeps (no config reaches them).
Module names follow the reference checkpoints, which
`combo_avs_tpu/train/checkpoint.py::convert_fusion` / `convert_audio_mlp` read
for MHA-B; the MHA-S block's (`a2i_attn.layer_norm_q_list.0`,
`a2i_attn.attn_list.0.q_proj`, `a2i_attn.gamma_list.0`) follow the same
pattern.
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
DROPOUT = 0.1  # on the attention maps in training mode (fusion.py:88-90 of the JAX package)
AUDIO_FEATURE_DIM = 128  # the VGGish embedding the fusion's audio side takes
FUSION_TYPES = ("MHA-B", "MHA-S", "MHA-S-Audio", "MHA-None")
N_HEADS = 8


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


class CrossAttention(nn.Module):
    """Clamped single-direction multi-head attention: q [B, N, q_dim] over
    k, v [B, S, k_dim] -> [B, N, q_dim]; dropout on the attention map in
    training mode."""

    def __init__(self, q_dim: int, k_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.q_proj = nn.Linear(q_dim, embed_dim)
        self.k_proj = nn.Linear(k_dim, embed_dim)
        self.v_proj = nn.Linear(k_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, q_dim)

    def init_params(self, g):
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.out_proj):
            init_xavier(lin, g)

    def forward(self, q, k, v, generator: Optional[torch.Generator] = None):
        B, N, _ = q.shape
        S = k.shape[1]
        M = self.num_heads
        hd = self.embed_dim // M
        qs = (self.q_proj(q) * hd**-0.5).reshape(B, N, M, hd)
        ks = self.k_proj(k).reshape(B, S, M, hd)
        vs = self.v_proj(v).reshape(B, S, M, hd)
        logits = torch.einsum("bnmd,bsmd->bmns", qs, ks).clamp(-CLAMP, CLAMP)
        attn = logits.softmax(-1)
        if self.training:
            attn = dropout(attn, DROPOUT, generator)
        out = torch.einsum("bmns,bsmd->bnmd", attn, vs).reshape(B, N, self.embed_dim)
        return self.out_proj(out)


class AttentionA2I(nn.Module):
    """Audio -> image fusion per level: pre-LayerNorms of the pixels and of
    the audio vector, cross-attention from the pixels to the audio, and a
    LayerScale residual on the post-norm pixels."""

    def __init__(self, q_dims: Sequence[int], k_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.layer_norm_q_list = nn.ModuleList(nn.LayerNorm(d, eps=LN_EPS) for d in q_dims)
        self.layer_norm_k_list = nn.ModuleList(nn.LayerNorm(k_dim, eps=LN_EPS) for _ in q_dims)
        self.attn_list = nn.ModuleList(
            CrossAttention(d, k_dim, embed_dim, num_heads) for d in q_dims)
        self.gamma_list = nn.ParameterList(nn.Parameter(torch.empty(d)) for d in q_dims)

    @torch.no_grad()
    def init_params(self, g):
        for p in self.gamma_list:
            p.fill_(GAMMA_INIT)

    def forward(self, visual: Sequence[torch.Tensor], audio,
                generator: Optional[torch.Generator] = None):
        out = []
        for lvl, feat in enumerate(visual):
            B, C, H, W = feat.shape
            q = self.layer_norm_q_list[lvl](feat.flatten(2).transpose(1, 2))
            ka = self.layer_norm_k_list[lvl](audio)
            q = q + self.gamma_list[lvl] * self.attn_list[lvl](q, ka, ka, generator)
            out.append(q.transpose(1, 2).reshape(B, C, H, W))
        return out


class AVFuse(nn.Module):
    """Fusion of the `fused_backbone` maps with the audio vector by
    `fused_type`; returns ({name: fused [B, C, H, W]}, audio [B, 1, 128]).
    `audio_dim` (FUSE_CONFIG.AUDIO_DIM) sizes the audio position embedding;
    the attention's audio side takes the 128-wide VGGish embedding, so MHA-B
    and MHA-S-Audio need audio_dim 128 (the JAX module fails on any other).

    A name listed twice is fused twice, as the JAX module does: each listing
    adds the level embedding again, of which there is one row
    (`level_embed[i]` of a one-row table is its row 0 in JAX)."""

    def __init__(self, audio_dim: int, fused_backbone: Sequence[str],
                 fused_backbone_dim: Sequence[int], fused_type: str = "MHA-B"):
        super().__init__()
        if fused_type not in FUSION_TYPES:
            raise ValueError(f"fusion type {fused_type!r}: one of {FUSION_TYPES}")
        if fused_type in ("MHA-B", "MHA-S-Audio") and audio_dim != AUDIO_FEATURE_DIM:
            raise ValueError(f"{fused_type} fuses the {AUDIO_FEATURE_DIM}-wide VGGish "
                             f"embedding: audio_dim must be {AUDIO_FEATURE_DIM}, not {audio_dim}")
        self.fused_type = fused_type
        self.fused_backbone = list(fused_backbone)
        self.pos_dim = fused_backbone_dim[0]
        embed_dim = max(fused_backbone_dim)
        self.audio_pos = nn.Embedding(1, audio_dim)
        self.level_embed = nn.Embedding(1, fused_backbone_dim[0])
        if fused_type in ("MHA-B", "MHA-S-Audio"):
            self.b_attn = BiAttentionBlock(fused_backbone_dim, AUDIO_FEATURE_DIM, embed_dim,
                                           N_HEADS)
        elif fused_type == "MHA-S":
            self.a2i_attn = AttentionA2I(fused_backbone_dim, AUDIO_FEATURE_DIM, embed_dim,
                                         N_HEADS)

    @torch.no_grad()
    def init_params(self, g):
        self.audio_pos.weight.normal_(0.0, 1.0, generator=g)
        self.level_embed.weight.normal_(0.0, 1.0, generator=g)

    def forward(self, visual_features: Dict[str, torch.Tensor], audio: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        feats = dict(visual_features)
        image_pos = None
        rows = self.level_embed.weight.shape[0]
        for i, name in enumerate(self.fused_backbone):
            f = feats[name]
            _, _, H, W = f.shape
            pe = sine_position_encoding(H, W, self.pos_dim // 2).reshape(1, H * W, -1)
            image_pos = torch.from_numpy(pe).to(f.device, f.dtype)
            feats[name] = f + self.level_embed.weight[min(i, rows - 1)][None, :, None, None]
        levels = [feats[name] for name in self.fused_backbone]
        out = dict(feats)
        if self.fused_type in ("MHA-B", "MHA-S-Audio"):
            pos_a = self.audio_pos.weight[None].expand(audio.shape[0], 1, -1)
            fused, audio = self.b_attn(levels, audio, pos_v=image_pos, pos_a=pos_a,
                                       generator=generator)
            if self.fused_type == "MHA-B":
                out.update(zip(self.fused_backbone, fused))
        elif self.fused_type == "MHA-S":
            out.update(zip(self.fused_backbone, self.a2i_attn(levels, audio, generator)))
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


class FeatureResizer(nn.Module):
    """Linear, LayerNorm (epsilon 1e-12) and dropout in training mode: the
    SCAN-era embedding resizer (no config builds it)."""

    def __init__(self, input_dim: int, output_dim: int, dropout_rate: float = 0.1,
                 do_ln: bool = True):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12) if do_ln else None
        self.dropout_rate = dropout_rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.fc(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        if self.training and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, generator)
        return x


def l1norm(x: torch.Tensor, dim: int, eps: float = 1e-8) -> torch.Tensor:
    return x / (x.abs().sum(dim, keepdim=True) + eps)


def l2norm(x: torch.Tensor, dim: int, eps: float = 1e-8) -> torch.Tensor:
    return x / ((x**2).sum(dim, keepdim=True).sqrt() + eps)


def func_attention(query: torch.Tensor, context: torch.Tensor, smooth: float = 1.0,
                   raw_feature_norm: str = "softmax", eps: float = 1e-8):
    """SCAN cross attention: query [B, Lq, D], context [B, Ls, D] ->
    (weighted context [B, Lq, D], attention [B, Ls, Lq])."""
    attn = torch.einsum("bsd,bqd->bsq", context, query)
    if raw_feature_norm == "softmax":
        attn = attn.softmax(-1)
    elif raw_feature_norm == "l2norm":
        attn = l2norm(attn, 2)
    elif raw_feature_norm == "clipped_l2norm":
        attn = l2norm(torch.nn.functional.leaky_relu(attn, 0.1), 2)
    else:
        raise ValueError(f"unknown norm {raw_feature_norm!r}")
    # normalize over the source, sharpen, renormalize
    attn = (attn.transpose(1, 2) * smooth).softmax(-1)  # [B, Lq, Ls]
    weighted = torch.einsum("bqs,bsd->bqd", attn, context)
    return weighted, attn.transpose(1, 2)
