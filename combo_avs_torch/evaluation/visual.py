"""Colour maps and PNG dumps of predictions: the port's copy of
`combo_avs_tpu/evaluation/visual.py` (ref: models/evaluation/misc/
visual.py:1-53): the binary and 71-class palettes, `colorize`, a per-image
binary mean IoU, and `save_mask_png`, written with the port's PNG encoder
(`data/png.py::write_png`) in place of cv2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from combo_avs_torch.data.png import write_png


def binary_color_map() -> np.ndarray:
    """[2, 3] palette: background black, sounding object white."""
    return np.asarray([[0, 0, 0], [255, 255, 255]], np.uint8)


def v2_pallete(num_classes: int = 71, seed: int = 1) -> np.ndarray:
    """Distinct colours for the AVSS 71-class labels, drawn from
    RandomState(seed) as the JAX package draws them; background black."""
    rng = np.random.RandomState(seed)
    pal = rng.randint(0, 255, (num_classes, 3)).astype(np.uint8)
    pal[0] = 0
    return pal


def colorize(mask: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """[H, W] int labels -> [H, W, 3] RGB."""
    return palette[np.clip(mask, 0, len(palette) - 1)]


def mean_iou(pred: np.ndarray, target: np.ndarray, eps: float = 1e-7) -> float:
    """Binary mean IoU over a batch (ref: visual.py:38-53): pred > 0.5
    against target > 0, per image, then the mean."""
    p = (np.asarray(pred) > 0.5).astype(np.int64)
    t = (np.asarray(target) > 0).astype(np.int64)
    inter = (p * t).sum(axis=(-1, -2))
    union = np.maximum(p, t).sum(axis=(-1, -2))
    return float(np.mean(inter / (union + eps)))


def save_mask_png(path: str, mask: np.ndarray, palette: Optional[np.ndarray] = None) -> None:
    """Write [H, W] int labels coloured by `palette` (the binary map by
    default), or an [H, W, 3] RGB image as it is, as an RGB PNG."""
    if mask.ndim == 2:
        rgb = colorize(mask, palette if palette is not None else binary_color_map())
    else:
        rgb = mask
    write_png(path, np.ascontiguousarray(rgb.astype(np.uint8)))
