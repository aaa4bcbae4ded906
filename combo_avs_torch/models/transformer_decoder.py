"""Masked-attention transformer decoder with audio-conditioned queries.

Port of `combo_avs_tpu/models/transformer_decoder.py`: the initial queries
are the learnable `query_feat` combined with the fused audio vector by
`queries_fuse_type` ("add": their sum; "dim": `query_feat` of hidden_dim -
audio_out_dim columns, the audio concatenated after it; "all": the audio
alone; "none": `query_feat` alone), `query_embed` positions; each
multi-scale map goes through a 1x1 `input_proj{i}` conv when its width is
not hidden_dim or `enforce_input_project` asks for one; per layer a masked cross-attention over one
of the 3 pixel-decoder scales (cycling i % 3), self-attention and FFN, all
post-norm; prediction heads after the queries and after every layer (shared
LayerNorm, class linear, 3-layer mask MLP, masks = <mask_embed,
mask_features>). The next layer's attention mask is sigmoid(mask) < 0.5 at
the next scale, with fully blocked rows un-blocked. `use_cosine_loss` False leaves
`middles_attn_mask` empty (the model without the inter-frame loss).

Module names follow the reference checkpoints
(`transformer_cross_attention_layers.N.multihead_attn`, ...), which
`combo_avs_tpu/train/checkpoint.py::convert_predictor` reads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from combo_avs_torch.models.layers import MLP, xavier_uniform_
from combo_avs_torch.models.position_encoding import sine_position_encoding

NEG_INF = -1e9
LN_EPS = 1e-6  # flax LayerNorm's default, as in the JAX package
NUM_FEATURE_LEVELS = 3
QUERIES_FUSE_TYPES = ("add", "dim", "all", "none")


class MultiheadAttention(nn.Module):
    """torch-style MHA with a packed in-projection. The attention is written
    out (matmul, masked_fill, softmax) because its boolean mask has True =
    blocked, filled with -1e9 rather than -inf, as in the JAX package."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    @torch.no_grad()
    def init_params(self, g):
        xavier_uniform_(self.in_proj_weight, g)
        self.in_proj_bias.zero_()

    def forward(self, query, key, value, attn_mask: Optional[torch.Tensor] = None):
        """query [B, Nq, C], key/value [B, Nk, C]; attn_mask broadcastable to
        [B, h, Nq, Nk], bool, True = blocked."""
        C, M = self.d_model, self.nhead
        hd = C // M
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:C], b[:C])
        k = F.linear(key, w[C : 2 * C], b[C : 2 * C])
        v = F.linear(value, w[2 * C :], b[2 * C :])
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        q = q.reshape(B, Nq, M, hd).transpose(1, 2)
        k = k.reshape(B, Nk, M, hd).transpose(1, 2)
        v = v.reshape(B, Nk, M, hd).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) * hd**-0.5
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, NEG_INF)
        out = logits.softmax(-1) @ v  # [B, M, Nq, hd]
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, C))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, attn_mask, pos, query_pos):
        return self.norm(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory, attn_mask))


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MultiScaleMaskedTransformerDecoder(nn.Module):
    def __init__(
        self,
        num_classes: int,
        hidden_dim: int = 256,
        num_queries: int = 100,
        nheads: int = 8,
        dim_feedforward: int = 2048,
        dec_layers: int = 9,  # = cfg DEC_LAYERS - 1
        mask_dim: int = 256,
        in_channels: Optional[int] = None,  # the maps' width; None: hidden_dim
        enforce_input_project: bool = False,
        queries_fuse_type: str = "add",
        audio_out_dim: Optional[int] = None,  # None: hidden_dim
        use_cosine_loss: bool = True,
    ):
        super().__init__()
        in_channels = hidden_dim if in_channels is None else in_channels
        audio_out_dim = hidden_dim if audio_out_dim is None else audio_out_dim
        if queries_fuse_type not in QUERIES_FUSE_TYPES:
            raise ValueError(f"queries_fuse_type {queries_fuse_type!r}: one of "
                             f"{QUERIES_FUSE_TYPES}")
        qdim = hidden_dim - audio_out_dim if queries_fuse_type == "dim" else hidden_dim
        if qdim < 0:
            raise ValueError(f"the dim query fusion needs hidden_dim ({hidden_dim}) of at "
                             f"least audio_out_dim ({audio_out_dim})")
        if queries_fuse_type in ("add", "all") and audio_out_dim != hidden_dim:
            raise ValueError(f"the {queries_fuse_type} query fusion needs audio_out_dim "
                             f"({audio_out_dim}) equal to hidden_dim ({hidden_dim})")
        self.num_queries, self.nheads, self.dec_layers = num_queries, nheads, dec_layers
        self.hidden_dim, self.queries_fuse_type = hidden_dim, queries_fuse_type
        self.use_cosine_loss = use_cosine_loss
        self.level_embed = nn.Embedding(NUM_FEATURE_LEVELS, hidden_dim)
        # an empty Sequential is the identity and holds no parameters, as in
        # the reference's `input_proj` list
        project = in_channels != hidden_dim or enforce_input_project
        self.input_proj = nn.ModuleList(
            nn.Conv2d(in_channels, hidden_dim, 1) if project else nn.Sequential()
            for _ in range(NUM_FEATURE_LEVELS))
        self.query_feat = nn.Embedding(num_queries, qdim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward) for _ in range(dec_layers))
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    @torch.no_grad()
    def init_params(self, g):
        for emb in (self.level_embed, self.query_feat, self.query_embed):
            emb.weight.normal_(0.0, 1.0, generator=g)

    def _prediction_heads(self, output, mask_features, target_size):
        d = self.decoder_norm(output)
        logits = self.class_embed(d)
        masks = torch.einsum("bqc,bchw->bqhw", self.mask_embed(d), mask_features)
        # bilinear without antialias, as the reference's F.interpolate downsample
        small = F.interpolate(masks, size=target_size, mode="bilinear",
                              align_corners=False, antialias=False)
        B, Q = masks.shape[:2]
        attn_mask = small.sigmoid().reshape(B, 1, Q, -1) < 0.5  # True = blocked
        return logits, masks, attn_mask

    def forward(
        self,
        x: Sequence[torch.Tensor],  # 3 multi-scale maps [B, C, H, W], coarse -> fine
        audio_features: torch.Tensor,  # [B, 1, audio_out_dim]
        mask_features: torch.Tensor,  # [B, mask_dim, H/4, W/4]
    ) -> Dict[str, object]:
        if len(x) != NUM_FEATURE_LEVELS:
            raise ValueError(f"expected {NUM_FEATURE_LEVELS} feature levels, got {len(x)}")
        B = mask_features.shape[0]
        C = self.hidden_dim
        srcs, poss, sizes = [], [], []
        for i, feat in enumerate(x):
            _, _, H, W = feat.shape
            sizes.append((H, W))
            pe = torch.from_numpy(sine_position_encoding(H, W, C // 2).reshape(1, H * W, C))
            poss.append(pe.to(feat.device, feat.dtype))
            feat = self.input_proj[i](feat)
            srcs.append(feat.flatten(2).transpose(1, 2) + self.level_embed.weight[i][None, None, :])

        q_pos = self.query_embed.weight[None].expand(B, -1, -1)
        query = self.query_feat.weight[None].expand(B, -1, -1)
        audio = audio_features.expand(B, self.num_queries, -1)
        output = {"add": lambda: query + audio, "dim": lambda: torch.cat([query, audio], -1),
                  "all": lambda: audio, "none": lambda: query}[self.queries_fuse_type]()

        predictions_class: List[torch.Tensor] = []
        predictions_mask: List[torch.Tensor] = []
        logits, masks, attn_mask = self._prediction_heads(output, mask_features, sizes[0])
        predictions_class.append(logits)
        predictions_mask.append(masks)

        for i in range(self.dec_layers):
            lvl = i % NUM_FEATURE_LEVELS
            # un-block rows with no allowed position
            attn_mask = attn_mask & ~attn_mask.all(-1, keepdim=True)
            output = self.transformer_cross_attention_layers[i](
                output, srcs[lvl], attn_mask, poss[lvl], q_pos)
            output = self.transformer_self_attention_layers[i](output, q_pos)
            output = self.transformer_ffn_layers[i](output)
            logits, masks, attn_mask = self._prediction_heads(
                output, mask_features, sizes[(i + 1) % NUM_FEATURE_LEVELS])
            predictions_class.append(logits)
            predictions_mask.append(masks)

        return {
            "pred_logits": predictions_class[-1],
            "pred_masks": predictions_mask[-1],
            "aux_outputs": [{"pred_logits": a, "pred_masks": b}
                            for a, b in zip(predictions_class[:-1], predictions_mask[:-1])],
            # the cosine loss's inputs: the first prediction and every layer's
            # but the last, each [B, Q, h*w]
            "middles_attn_mask": [m.reshape(B, self.num_queries, -1)
                                  for m in predictions_mask[:-1]] if self.use_cosine_loss else [],
        }
