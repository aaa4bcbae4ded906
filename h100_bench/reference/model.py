"""The plain reference of COMBO-AVS: the upstream graph in plain PyTorch.

A frozen copy of the repository's end-to-end oracle (the upstream model
graph, ref: models/maskformer_model.py:274-391 and the modules it builds),
widened to training: frozen BatchNorm statistics and affine as buffers, the
PVT towers' stochastic depth, the fusion's attention dropout and the
decoder's per-layer masks for the inter-frame cosine loss. `state_dict()`
gives the reference checkpoints' key names, which the measured program
loads as they are.

Departures from the upstream description, each to compute the function
the measured configuration states:
- LayerNorms of the pixel decoder, the fusion and the decoder use epsilon
  1e-6 (flax's default, which the repository's JAX system and its port
  use); upstream's torch default is 1e-5.
- Dropout and drop-path masks are drawn from an explicit generator as
  `torch.rand(shape) < 1 - rate`, one draw per call in forward order: the
  visual tower's blocks (attention branch, then MLP branch), the Maskige
  tower's, then the fusion's two attention maps. Given a generator seeded
  alike, the masks are the program's.

Imports nothing but torch: no kernel, no module of the measured program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
LN_EPS = 1e-6
FUSION_DROPOUT = 0.1
PVT_DROP_PATH = 0.1


def _keep_mask(shape, rate: float, generator: Optional[torch.Generator], device):
    if generator is None:
        raise ValueError("dropout in training mode needs a generator")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def drop_path(x: torch.Tensor, rate: float, generator, training: bool) -> torch.Tensor:
    if not training or rate == 0.0:
        return x
    keep = _keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator, training: bool) -> torch.Tensor:
    if not training or rate == 0.0:
        return x
    keep = _keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class FrozenBN(nn.Module):
    """d2 FrozenBatchNorm2d: statistics and affine are buffers."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


class D2Conv(nn.Conv2d):
    """d2-style Conv2d with a trailing `.norm` submodule."""

    def __init__(self, *a, norm=None, **kw):
        super().__init__(*a, **kw)
        self.norm = norm

    def forward(self, x):
        x = super().forward(x)
        return x if self.norm is None else self.norm(x)


class Bottleneck(nn.Module):
    """d2 ResNet bottleneck (stride in the 3x3: STRIDE_IN_1X1 False)."""

    def __init__(self, cin, mid, cout, stride):
        super().__init__()
        self.conv1 = D2Conv(cin, mid, 1, 1, bias=False, norm=FrozenBN(mid))
        self.conv2 = D2Conv(mid, mid, 3, stride, 1, bias=False, norm=FrozenBN(mid))
        self.conv3 = D2Conv(mid, cout, 1, 1, bias=False, norm=FrozenBN(cout))
        self.shortcut = None
        if stride != 1 or cin != cout:
            self.shortcut = D2Conv(cin, cout, 1, stride, bias=False, norm=FrozenBN(cout))

    def forward(self, x):
        idn = x if self.shortcut is None else self.shortcut(x)
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return F.relu(self.conv3(x) + idn)


class ResNet50(nn.Module):
    """d2-named R50 (stem.conv1, res{2..5}.{i}.conv{1..3}), FrozenBN."""

    def __init__(self, blocks=(3, 4, 6, 3)):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv1 = D2Conv(3, 64, 7, 2, 3, bias=False, norm=FrozenBN(64))
        cin = 64
        for s, (mid, cout, st) in enumerate([(64, 256, 1), (128, 512, 2), (256, 1024, 2),
                                             (512, 2048, 2)]):
            layers = []
            for b in range(blocks[s]):
                layers.append(Bottleneck(cin, mid, cout, st if b == 0 else 1))
                cin = cout
            setattr(self, f"res{s + 2}", nn.Sequential(*layers))

    def forward(self, x, generator=None):
        x = F.max_pool2d(F.relu(self.stem.conv1(x)), 3, 2, 1)
        out = {}
        for s in range(2, 6):
            x = getattr(self, f"res{s}")(x)
            out[f"res{s}"] = x
        return out


class VGGish(nn.Module):
    """ref: audio_backbone/torchvggish/vggish.py:9-27,95-105."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(1, 64, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(64, 128, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(256, 512, 3, padding=1), nn.ReLU(),
            nn.Conv2d(512, 512, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2, 2),
        )
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 4 * 6, 4096), nn.ReLU(),
            nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, 128), nn.ReLU(),
        )

    def forward(self, x):  # [N, 1, 96, 64]
        x = self.features(x)
        x = torch.transpose(x, 1, 3)
        x = torch.transpose(x, 1, 2)  # [N, 6, 4, 512]
        return self.embeddings(x.flatten(1))


class PVTBlock(nn.Module):
    """ref: pvtv2.py:60-190 (pre-norm SRA block, exact-GELU conv MLP)."""

    def __init__(self, dim, heads, sr, drop_rate, mlp_ratio=4):
        super().__init__()
        self.heads, self.sr_ratio, self.drop_rate = heads, sr, drop_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.q = nn.Linear(dim, dim)
        self.attn.kv = nn.Linear(dim, dim * 2)
        self.attn.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.attn.sr = nn.Conv2d(dim, dim, sr, sr)
            self.attn.norm = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp.dwconv = nn.Module()
        self.mlp.dwconv.dwconv = nn.Conv2d(dim * mlp_ratio, dim * mlp_ratio, 3, 1, 1,
                                           groups=dim * mlp_ratio)
        self.mlp.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def _attention(self, x, H, W):
        B, N, C = x.shape
        hd = C // self.heads
        a = self.attn
        q = a.q(x).reshape(B, N, self.heads, hd).permute(0, 2, 1, 3)
        kvin = x
        if self.sr_ratio > 1:
            xm = a.sr(x.transpose(1, 2).reshape(B, C, H, W)).reshape(B, C, -1).transpose(1, 2)
            kvin = a.norm(xm)
        kv = a.kv(kvin).reshape(B, -1, 2, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q @ kv[0].transpose(-2, -1)) * hd**-0.5
        return a.proj((attn.softmax(-1) @ kv[1]).transpose(1, 2).reshape(B, N, C))

    def _mlp(self, x, H, W):
        h = self.mlp.fc1(x)
        B, N, C = h.shape
        h = self.mlp.dwconv.dwconv(h.transpose(1, 2).reshape(B, C, H, W))
        return self.mlp.fc2(F.gelu(h.flatten(2).transpose(1, 2)))

    def forward(self, x, H, W, generator):
        x = x + drop_path(self._attention(self.norm1(x), H, W), self.drop_rate, generator,
                          self.training)
        return x + drop_path(self._mlp(self.norm2(x), H, W), self.drop_rate, generator,
                             self.training)


class PVTv2(nn.Module):
    """PVTv2 (B5 at depths 3/6/40/3) under timm's key names:
    patch_embed{i}.proj/.norm, block{i}.{j}.*, norm{i}; drop path rising
    linearly from 0 to 0.1 over all blocks in order."""

    dims = (64, 128, 320, 512)
    heads = (1, 2, 5, 8)
    srs = (8, 4, 2, 1)

    def __init__(self, depths=(3, 6, 40, 3)):
        super().__init__()
        self.depths = tuple(depths)
        n = sum(self.depths)
        rates = [PVT_DROP_PATH * i / (n - 1) if n > 1 else 0.0 for i in range(n)]
        cin, k = 3, 0
        for i, d in enumerate(self.dims):
            patch, stride = (7, 4) if i == 0 else (3, 2)
            pe = nn.Module()
            pe.proj = nn.Conv2d(cin, d, patch, stride, patch // 2)
            pe.norm = nn.LayerNorm(d, eps=1e-6)
            setattr(self, f"patch_embed{i + 1}", pe)
            setattr(self, f"block{i + 1}", nn.ModuleList(
                PVTBlock(d, self.heads[i], self.srs[i], rates[k + j]) for j in range(depths[i])))
            k += depths[i]
            setattr(self, f"norm{i + 1}", nn.LayerNorm(d, eps=1e-6))
            cin = d

    def forward(self, x, generator=None):
        out = {}
        for i in range(4):
            pe = getattr(self, f"patch_embed{i + 1}")
            x = pe.proj(x)
            B, C, H, W = x.shape
            x = pe.norm(x.flatten(2).transpose(1, 2))
            for blk in getattr(self, f"block{i + 1}"):
                x = blk(x, H, W, generator)
            x = getattr(self, f"norm{i + 1}")(x).transpose(1, 2).reshape(B, C, H, W)
            out[f"res{i + 2}"] = x
        return out


class SEBlock(nn.Module):
    """ref: models/utils/misc.py:112-131 channel_weighted_block."""

    def __init__(self, dim, reduction=16):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim // reduction)
        self.fc2 = nn.Linear(dim // reduction, dim)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return y[:, :, None, None]


def sine_pe(H, W, num_pos_feats, device, dtype):
    """DETR normalized 2D sine PE -> [H*W, 2*num_pos_feats], y block first
    (ref: transformer_decoder/position_encoding.py:12-60)."""
    y = torch.arange(1, H + 1, dtype=torch.float32, device=device)[:, None].expand(H, W)
    x = torch.arange(1, W + 1, dtype=torch.float32, device=device)[None, :].expand(H, W)
    scale = 2 * math.pi
    y = y / (H + 1e-6) * scale
    x = x / (W + 1e-6) * scale
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.floor(i / 2) / num_pos_feats)
    py, px = y[..., None] / dim_t, x[..., None] / dim_t
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), dim=3).flatten(2)
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), dim=3).flatten(2)
    return torch.cat((py, px), dim=2).reshape(H * W, -1).to(dtype)


def ms_deform_core(value, shapes, loc, weights):
    """Deformable-DETR sampling core through F.grid_sample (ref:
    ops/functions/ms_deform_attn_func.py:53-72). value [B,S,M,D], loc
    [B,Lq,M,L,P,2] in [0, 1], weights [B,Lq,M,L,P]."""
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    per_level = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    acc = []
    for lvl, (H, W) in enumerate(shapes):
        v = per_level[lvl].flatten(2).transpose(1, 2).reshape(B * M, D, H, W)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # [B*M, Lq, P, 2]
        acc.append(F.grid_sample(v, g.to(v.dtype), mode="bilinear", padding_mode="zeros",
                                 align_corners=False))
    stacked = torch.stack(acc, dim=-2)  # [B*M, D, Lq, L, P]
    w = weights.transpose(1, 2).reshape(B * M, 1, Lq, L * P)
    out = (stacked.flatten(-2) * w).sum(-1)
    return out.view(B, M * D, Lq).transpose(1, 2)


class MSDeformAttn(nn.Module):
    """ref: ops/modules/ms_deform_attn.py:28-129."""

    def __init__(self, d_model, n_levels, n_heads=8, n_points=4):
        super().__init__()
        self.M, self.L, self.P = n_heads, n_levels, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, value_src, shapes):
        B, Lq, C = query.shape
        M, L, P = self.M, self.L, self.P
        value = self.value_proj(value_src).view(B, -1, M, C // M)
        off = self.sampling_offsets(query).view(B, Lq, M, L, P, 2)
        w = self.attention_weights(query).view(B, Lq, M, L * P).softmax(-1).view(B, Lq, M, L, P)
        normalizer = torch.tensor([[wd, ht] for ht, wd in shapes], dtype=off.dtype,
                                  device=off.device)
        loc = reference_points[None, :, None, :, None, :] + off / normalizer[None, None, None, :,
                                                                             None, :]
        return self.output_proj(ms_deform_core(value, shapes, loc, w))


class EncoderLayer(nn.Module):
    """ref: msdeformattn.py:99-137 (post-norm, ReLU FFN, dropout 0)."""

    def __init__(self, d_model, d_ffn, n_levels, n_heads):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, ref, shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref, src, shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class PixelDecoder(nn.Module):
    """ref: msdeformattn.py:168-359: res3-5 deformable encoder and one FPN
    step to stride 4."""

    def __init__(self, in_channels, conv_dim=256, mask_dim=256, enc_layers=6, n_heads=8,
                 d_ffn=1024):
        super().__init__()
        self.input_proj = nn.ModuleList([
            nn.Sequential(nn.Conv2d(c, conv_dim, 1), nn.GroupNorm(32, conv_dim))
            for c in in_channels[:0:-1]])
        self.transformer = nn.Module()
        self.transformer.level_embed = nn.Parameter(torch.zeros(3, conv_dim))
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            EncoderLayer(conv_dim, d_ffn, 3, n_heads) for _ in range(enc_layers))
        self.adapter_1 = D2Conv(in_channels[0], conv_dim, 1, bias=False,
                                norm=nn.GroupNorm(32, conv_dim))
        self.layer_1 = D2Conv(conv_dim, conv_dim, 3, padding=1, bias=False,
                              norm=nn.GroupNorm(32, conv_dim))
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)
        self.conv_dim = conv_dim

    @staticmethod
    def reference_points(shapes, device):
        pts = []
        for h, w in shapes:
            ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        return torch.cat(pts, 0)[:, None, :].expand(-1, len(shapes), -1)

    def forward(self, features):
        srcs, poss, shapes = [], [], []
        for idx, name in enumerate(["res5", "res4", "res3"]):
            x = self.input_proj[idx](features[name])
            B, C, H, W = x.shape
            srcs.append(x.flatten(2).transpose(1, 2))
            pe = sine_pe(H, W, self.conv_dim // 2, x.device, x.dtype)[None]
            poss.append(pe + self.transformer.level_embed[idx][None, None, :])
            shapes.append((H, W))
        src, pos = torch.cat(srcs, 1), torch.cat(poss, 1)
        ref = self.reference_points(shapes, src.device).to(src.dtype)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, ref, shapes)
        out, start = [], 0
        for H, W in shapes:
            out.append(src[:, start:start + H * W].transpose(1, 2).reshape(-1, self.conv_dim, H, W))
            start += H * W
        lat = self.adapter_1(features["res2"])
        up = F.interpolate(out[-1], size=lat.shape[-2:], mode="bilinear", align_corners=False)
        return self.mask_features(F.relu(self.layer_1(lat + up))), out[:3]


class BiMHA(nn.Module):
    """ref: fuse_helper.py:102-237 (one QK^T, softmax both directions)."""

    def __init__(self, v_dim, a_dim, embed_dim, num_heads):
        super().__init__()
        self.M, self.E = num_heads, embed_dim
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.a_proj = nn.Linear(a_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_a_proj = nn.Linear(a_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_a_proj = nn.Linear(embed_dim, a_dim)

    def forward(self, v, a, pos_v, pos_a, generator):
        B, N, _ = v.shape
        M, hd = self.M, self.E // self.M
        q = (self.v_proj(v + pos_v) * hd**-0.5).view(B, N, M, hd).transpose(1, 2)
        k = self.a_proj(a + pos_a).view(B, 1, M, hd).transpose(1, 2)
        vv = self.values_v_proj(v).view(B, N, M, hd).transpose(1, 2)
        va = self.values_a_proj(a).view(B, 1, M, hd).transpose(1, 2)
        logits = (q @ k.transpose(-2, -1))[..., 0].clamp(-50000, 50000)  # [B, M, N]
        attn_v = logits.softmax(dim=-1)
        attn_a = (logits - logits.amax(-1, keepdim=True)).softmax(-1)
        attn_v = dropout(attn_v, FUSION_DROPOUT, generator, self.training)
        attn_a = dropout(attn_a, FUSION_DROPOUT, generator, self.training)
        out_v = (attn_v[..., None] @ va).transpose(1, 2).reshape(B, N, self.E)
        out_a = (attn_a[:, :, None, :] @ vv).transpose(1, 2).reshape(B, 1, self.E)
        return self.out_v_proj(out_v), self.out_a_proj(out_a)


class Fusion(nn.Module):
    """AVFuse MHA-B on the mask features (ref: AVFuse.py:10-126,
    fuse_helper.py:240-332)."""

    def __init__(self, v_dim=256, a_dim=128, embed_dim=256, num_heads=8):
        super().__init__()
        self.audio_pos = nn.Embedding(1, a_dim)
        self.level_embed = nn.Embedding(1, v_dim)
        b = nn.Module()
        b.layer_norm_v_list = nn.ModuleList([nn.LayerNorm(v_dim, eps=LN_EPS)])
        b.layer_norm_a_list = nn.ModuleList([nn.LayerNorm(a_dim, eps=LN_EPS)])
        b.attn_list = nn.ModuleList([BiMHA(v_dim, a_dim, embed_dim, num_heads)])
        b.gamma_v_list = nn.ParameterList([nn.Parameter(1e-4 * torch.ones(v_dim))])
        b.gamma_a = nn.Parameter(1e-4 * torch.ones(a_dim))
        self.b_attn = b
        self.v_dim, self.a_dim = v_dim, a_dim

    def forward(self, feat, audio, generator):
        B, C, H, W = feat.shape
        pos_v = sine_pe(H, W, self.v_dim // 2, feat.device, feat.dtype)[None]
        v = (feat + self.level_embed.weight[0][None, :, None, None]).flatten(2).transpose(1, 2)
        pos_a = self.audio_pos.weight[None].expand(B, 1, self.a_dim)
        v = self.b_attn.layer_norm_v_list[0](v)
        a = self.b_attn.layer_norm_a_list[0](audio)
        dv, da = self.b_attn.attn_list[0](v, a, pos_v, pos_a, generator)
        v = v + self.b_attn.gamma_v_list[0] * dv
        a = a + self.b_attn.gamma_a * da
        return v.transpose(1, 2).reshape(B, C, H, W), a


class Predictor(nn.Module):
    """ref: transformer_decoder.py:222-519: masked cross-attention ->
    self-attention -> FFN, prediction heads after each layer, 'add' audio
    query fusion."""

    def __init__(self, num_classes=2, hidden_dim=256, num_queries=100, nheads=8,
                 dim_feedforward=2048, dec_layers=9, mask_dim=256):
        super().__init__()
        self.Q, self.C, self.M, self.dec_layers = num_queries, hidden_dim, nheads, dec_layers
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(3, hidden_dim)
        self.transformer_cross_attention_layers = nn.ModuleList()
        self.transformer_self_attention_layers = nn.ModuleList()
        self.transformer_ffn_layers = nn.ModuleList()
        for _ in range(dec_layers):
            ca, sa, ff = nn.Module(), nn.Module(), nn.Module()
            ca.multihead_attn = nn.MultiheadAttention(hidden_dim, nheads, batch_first=True)
            ca.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
            sa.self_attn = nn.MultiheadAttention(hidden_dim, nheads, batch_first=True)
            sa.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
            ff.linear1 = nn.Linear(hidden_dim, dim_feedforward)
            ff.linear2 = nn.Linear(dim_feedforward, hidden_dim)
            ff.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
            self.transformer_cross_attention_layers.append(ca)
            self.transformer_self_attention_layers.append(sa)
            self.transformer_ffn_layers.append(ff)
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = nn.Module()
        self.mask_embed.layers = nn.ModuleList([
            nn.Linear(hidden_dim, hidden_dim), nn.Linear(hidden_dim, hidden_dim),
            nn.Linear(hidden_dim, mask_dim)])

    def _heads(self, output, mask_features, target_size):
        d = self.decoder_norm(output)
        emb = d
        for i, lin in enumerate(self.mask_embed.layers):
            emb = lin(emb) if i == 2 else F.relu(lin(emb))
        masks = torch.einsum("bqc,bchw->bqhw", emb, mask_features)
        small = F.interpolate(masks, size=target_size, mode="bilinear", align_corners=False)
        am = (small.sigmoid().flatten(2) < 0.5)[:, None].expand(-1, self.M, -1, -1)
        return self.class_embed(d), masks, am.detach()

    def forward(self, ms, audio, mask_features):
        B = mask_features.shape[0]
        srcs, poss, sizes = [], [], []
        for i, feat in enumerate(ms):
            _, C, H, W = feat.shape
            sizes.append((H, W))
            poss.append(sine_pe(H, W, self.C // 2, feat.device, feat.dtype)[None])
            srcs.append(feat.flatten(2).transpose(1, 2) + self.level_embed.weight[i][None, None, :])
        q_pos = self.query_embed.weight[None].expand(B, -1, -1)
        output = self.query_feat.weight[None].expand(B, -1, -1) + audio.expand(B, self.Q, -1)
        cls_list, mask_list = [], []
        logits, masks, am = self._heads(output, mask_features, sizes[0])
        cls_list.append(logits)
        mask_list.append(masks)
        for i in range(self.dec_layers):
            lvl = i % 3
            am = am & ~am.all(dim=-1, keepdim=True)
            ca = self.transformer_cross_attention_layers[i]
            t2, _ = ca.multihead_attn(output + q_pos, srcs[lvl] + poss[lvl], srcs[lvl],
                                      attn_mask=am.reshape(B * self.M, self.Q, -1),
                                      need_weights=False)
            output = ca.norm(output + t2)
            sa = self.transformer_self_attention_layers[i]
            t2, _ = sa.self_attn(output + q_pos, output + q_pos, output, need_weights=False)
            output = sa.norm(output + t2)
            ff = self.transformer_ffn_layers[i]
            output = ff.norm(output + ff.linear2(F.relu(ff.linear1(output))))
            logits, masks, am = self._heads(output, mask_features, sizes[(i + 1) % 3])
            cls_list.append(logits)
            mask_list.append(masks)
        return {
            "pred_logits": cls_list[-1],
            "pred_masks": mask_list[-1],
            "aux_outputs": [{"pred_logits": a, "pred_masks": b}
                            for a, b in zip(cls_list[:-1], mask_list[:-1])],
            "middles_attn_mask": [m.flatten(2) for m in mask_list[:-1]],
        }


class Combo(nn.Module):
    """COMBO-AVS, S4/MS3 late-fusion MHA-B with the Siam-Encoder (Maskige)
    tower and SE gates; `backbone` "resnet" (R50) or "pvt" (PVTv2)."""

    def __init__(self, backbone="resnet", num_classes=2, num_queries=100, enc_layers=6,
                 dec_layers=9, pvt_depths=(3, 6, 40, 3), resnet_blocks=(3, 4, 6, 3)):
        super().__init__()
        if backbone == "pvt":
            self.backbone, self.pre_sam_backbone = PVTv2(pvt_depths), PVTv2(pvt_depths)
            dims = PVTv2.dims
        else:
            self.backbone = ResNet50(resnet_blocks)
            self.pre_sam_backbone = ResNet50(resnet_blocks)
            dims = (256, 512, 1024, 2048)
        self.audio_backbone = VGGish()
        self.scale_factor_module = nn.ModuleList([SEBlock(d) for d in dims])
        sem = nn.Module()
        sem.pixel_decoder = PixelDecoder(in_channels=dims, enc_layers=enc_layers)
        sem.fusion_module = Fusion()
        sem.audio_transformation = nn.Module()
        sem.audio_transformation.embeddings = nn.Sequential(
            nn.Linear(128, 4096), nn.ReLU(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, 256))
        sem.predictor = Predictor(num_classes=num_classes, num_queries=num_queries,
                                  dec_layers=dec_layers)
        self.sem_seg_head = sem

    def _normalize(self, x, dtype):
        """[N, H, W, 3] raw RGB (uint8 or float) -> normalized [N, 3, H, W]."""
        mean = torch.tensor(PIXEL_MEAN, dtype=dtype, device=x.device)
        std = torch.tensor(PIXEL_STD, dtype=dtype, device=x.device)
        return ((x.to(dtype) - mean) / std).permute(0, 3, 1, 2).contiguous()

    def forward(self, images, audio_log_mel, pre_masks, generator=None):
        """images, pre_masks [B, T, H, W, 3] raw RGB; audio_log_mel [B, T, 96,
        64] -> the upstream output dict over B*T frames. In training mode the
        drop-path and dropout masks come from `generator`."""
        B, T, H, W, _ = images.shape
        dtype = next(self.parameters()).dtype
        with torch.no_grad():  # the frozen VGGish (FREEZE_AUDIO_EXTRACTOR)
            audio = self.audio_backbone(audio_log_mel.reshape(B * T, 1, 96, 64).to(dtype))
        audio = audio[:, None, :]
        feats = self.backbone(self._normalize(images.reshape(B * T, H, W, 3), dtype), generator)
        pre = self.pre_sam_backbone(self._normalize(pre_masks.reshape(B * T, H, W, 3), dtype),
                                    generator)
        for i, k in enumerate(["res2", "res3", "res4", "res5"]):
            feats[k] = feats[k] + self.scale_factor_module[i](pre[k]) * pre[k]
        head = self.sem_seg_head
        mask_features, ms = head.pixel_decoder(feats)
        mask_features, a = head.fusion_module(mask_features, audio, generator)
        return head.predictor(ms, head.audio_transformation.embeddings(a), mask_features)


def semantic_inference(pred_logits: torch.Tensor, pred_masks: torch.Tensor,
                       out_size) -> torch.Tensor:
    """ref: maskformer_model.py semantic_inference with the upsample to the
    output size first: softmax(cls)[..., :-1] x sigmoid(masks) summed over
    queries, float32 [N, C, H, W]."""
    masks = F.interpolate(pred_masks.float(), size=tuple(out_size), mode="bilinear",
                          align_corners=False)
    cls = pred_logits.float().softmax(-1)[..., :-1]
    return torch.einsum("nqc,nqhw->nchw", cls, masks.sigmoid())


def build(spec: Dict, device) -> Combo:
    """The reference for a configuration file's `model` section."""
    with torch.device(device):
        return Combo(backbone=spec["backbone"], num_classes=spec["num_classes"],
                     num_queries=spec["num_queries"], enc_layers=spec["enc_layers"],
                     dec_layers=spec["dec_layers"] - 1,
                     pvt_depths=tuple(spec.get("pvt_depths", (3, 6, 40, 3))),
                     resnet_blocks=tuple(spec.get("resnet_blocks", (3, 4, 6, 3))))
