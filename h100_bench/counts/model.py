"""Model FLOPs of a step, counted from the configuration's shapes.

The operations of matrix products and convolutions (2 per multiply-add),
as `torch.utils.flop_counter.FlopCounterMode` counts them, of the upstream
graph (`h100_bench.reference.model`): the same count whatever implements
it. Elementwise work, norms, softmax, resampling and bilinear sampling are
not counted. A training step counts 3x the forward of every layer on the
path from a trained parameter to the loss (forward, and the two products of
the backward) and 1x the frozen VGGish; nothing is counted for recompute.
An evaluation step counts the forward and the semantic-inference
contraction at the output size.
"""

from __future__ import annotations

from typing import Dict, Tuple


def _conv(hw_out: Tuple[int, int], cin: int, cout: int, k: int, groups: int = 1) -> int:
    return 2 * hw_out[0] * hw_out[1] * cout * (cin // groups) * k * k


def _lin(rows: int, cin: int, cout: int) -> int:
    return 2 * rows * cin * cout


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet50(S: int, blocks=(3, 4, 6, 3)) -> Tuple[int, Dict[str, Tuple[int, int, int]]]:
    """FLOPs of one frame through the d2 R50, and res2..5 (channels, H, W)."""
    f = 0
    h = _out(S, 7, 2, 3)
    f += _conv((h, h), 3, 64, 7)
    h = _out(h, 3, 2, 1)
    cin, feats = 64, {}
    for s, (mid, cout, stride) in enumerate([(64, 256, 1), (128, 512, 2), (256, 1024, 2),
                                             (512, 2048, 2)]):
        for b in range(blocks[s]):
            st = stride if b == 0 else 1
            ho = _out(h, 3, st, 1)
            f += _conv((h, h), cin, mid, 1)
            f += _conv((ho, ho), mid, mid, 3)
            f += _conv((ho, ho), mid, cout, 1)
            if st != 1 or cin != cout:
                f += _conv((ho, ho), cin, cout, 1)
            h, cin = ho, cout
        feats[f"res{s + 2}"] = (cout, h, h)
    return f, feats


PVT_DIMS, PVT_HEADS, PVT_SRS = (64, 128, 320, 512), (1, 2, 5, 8), (8, 4, 2, 1)


def pvtv2(S: int, depths=(3, 6, 40, 3), mlp_ratio: int = 4):
    """FLOPs of one frame through PVTv2, and res2..5 (channels, H, W)."""
    f, cin, h, feats = 0, 3, S, {}
    for i, C in enumerate(PVT_DIMS):
        k, st = (7, 4) if i == 0 else (3, 2)
        h = _out(h, k, st, k // 2)
        f += _conv((h, h), cin, C, k)
        N, sr = h * h, PVT_SRS[i]
        hs = h // sr if sr > 1 else h
        Nk = hs * hs
        block = _lin(N, C, C)  # q
        if sr > 1:
            block += _conv((hs, hs), C, C, sr)
        block += _lin(Nk, C, 2 * C)  # kv
        block += 2 * 2 * N * Nk * C  # q k^T and attn v over all heads
        block += _lin(N, C, C)  # proj
        block += _lin(N, C, mlp_ratio * C) + _conv((h, h), mlp_ratio * C, mlp_ratio * C, 3,
                                                   groups=mlp_ratio * C)
        block += _lin(N, mlp_ratio * C, C)
        f += depths[i] * block
        feats[f"res{i + 2}"] = (C, h, h)
        cin = C
    return f, feats


def vggish() -> int:
    """One 96 x 64 log-mel frame through VGGish."""
    f, h, w = 0, 96, 64
    for cin, cout, pool in ((1, 64, True), (64, 128, True), (128, 256, False), (256, 256, True),
                            (256, 512, False), (512, 512, True)):
        f += _conv((h, w), cin, cout, 3)
        if pool:
            h, w = h // 2, w // 2
    return f + _lin(1, 512 * 4 * 6, 4096) + _lin(1, 4096, 4096) + _lin(1, 4096, 128)


def head(feats: Dict[str, Tuple[int, int, int]], m: Dict) -> int:
    """One frame through the SE gates, the pixel decoder, the fusion, the
    audio MLP and the decoder with its prediction heads."""
    E, Q, D = m["hidden_dim"], m["num_queries"], m["conv_dim"]
    f = sum(_lin(1, c, c // 16) + _lin(1, c // 16, c) for c, _, _ in feats.values())  # SE
    levels = [feats[k] for k in ("res5", "res4", "res3")]
    S = sum(h * w for _, h, w in levels)
    f += sum(_conv((h, w), c, D, 1) for c, h, w in levels)
    L, P, M = 3, m["enc_points"], m["nheads"]
    enc = _lin(S, D, D) * 2 + _lin(S, D, M * L * P * 2) + _lin(S, D, M * L * P)
    enc += _lin(S, D, m["enc_ffn"]) + _lin(S, m["enc_ffn"], D)
    f += m["enc_layers"] * enc
    c2, h2, w2 = feats["res2"]
    f += _conv((h2, w2), c2, D, 1) + _conv((h2, w2), D, D, 3) + _conv((h2, w2), D, m["mask_dim"], 1)
    Nv, A = h2 * w2, m["audio_dim"]
    f += 3 * _lin(Nv, D, E) + 2 * _lin(1, A, E) + _lin(1, E, A) + 3 * 2 * Nv * E  # fusion
    f += _lin(1, A, 4096) + _lin(1, 4096, 4096) + _lin(1, 4096, E)  # audio MLP
    heads = _lin(Q, E, m["num_classes"] + 1) + 3 * _lin(Q, E, E) + 2 * Q * E * Nv
    dec_layers = m["dec_layers"] - 1
    f += (dec_layers + 1) * heads
    for i in range(dec_layers):
        _, h, w = levels[i % 3]
        Sl = h * w
        f += _lin(Q, E, E) + 2 * _lin(Sl, E, E) + 4 * Q * Sl * E + _lin(Q, E, E)  # cross
        f += 4 * _lin(Q, E, E) + 4 * Q * Q * E  # self
        f += _lin(Q, E, m["dim_feedforward"]) + _lin(Q, m["dim_feedforward"], E)  # FFN
    return f


def forward_per_frame(m: Dict, size: int) -> Dict[str, int]:
    """{"towers", "vggish", "head"} FLOPs of one frame's forward."""
    if m["backbone"] == "pvt":
        tower, feats = pvtv2(size, tuple(m["pvt_depths"]))
    else:
        tower, feats = resnet50(size, tuple(m.get("resnet_blocks", (3, 4, 6, 3))))
    return {"towers": 2 * tower, "vggish": vggish(), "head": head(feats, m)}


def step_flops(m: Dict, traffic: Dict, mode: str) -> int:
    """Model FLOPs of one step of a cell (`mode` "train" or "eval")."""
    frames = traffic["videos"] * traffic["frames"]
    per = forward_per_frame(m, traffic["size"])
    if mode == "train":
        return frames * (3 * (per["towers"] + per["head"]) + per["vggish"])
    out = traffic["out_size"]
    seminf = 2 * m["num_queries"] * m["num_classes"] * out[0] * out[1]
    return frames * (per["towers"] + per["head"] + per["vggish"] + seminf)
