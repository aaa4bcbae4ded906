"""2-D sinusoidal position encoding (DETR convention), numpy float32.

Same arithmetic, in the same order and type, as
`combo_avs_tpu/models/position_encoding.py::sine_position_encoding`, so the
constants are bit-identical on both sides: cumsum-normalized y/x ramps scaled
to 2*pi, a geometric frequency ladder of `num_pos_feats` channels each, sin on
even / cos on odd channel pairs, y block first.
"""

from __future__ import annotations

import functools

import numpy as np

TEMPERATURE = 10000.0
EPS = 1e-6


@functools.lru_cache(maxsize=None)
def sine_position_encoding(
    h: int, w: int, num_pos_feats: int = 128, normalize: bool = True
) -> np.ndarray:
    """Returns [H, W, 2*num_pos_feats] (y-channels then x-channels). Cached:
    treat the result as read-only."""
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    if normalize:
        scale = 2 * np.pi
        y = y / (y[-1:, :] + EPS) * scale
        x = x / (x[:, -1:] + EPS) * scale

    i = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = TEMPERATURE ** (2 * np.floor(i / 2) / num_pos_feats)

    pos_y = y[:, :, None] / dim_t
    pos_x = x[:, :, None] / dim_t
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(
        h, w, num_pos_feats
    )
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(
        h, w, num_pos_feats
    )
    return np.concatenate([pos_y, pos_x], axis=-1)
