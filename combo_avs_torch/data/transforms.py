"""Training augmentation, numpy only: one transform sampled per video and
replayed on every frame (resize, crop, SSD colour jitter, flip).

Port of `combo_avs_tpu/data/mappers.py:70-181` (`VideoTransform`, `_cvt`,
`_apply_ssd_color`, `sample_video_transform`; ref: models/data/
dataset_mappers/avss4_semantic_dataset_mapper.py:70-95 and detectron2's
`ColorAugSSDTransform`), with the four cv2 calls it makes written out in the
fixed-point arithmetic cv2 uses, so that the bytes are cv2's:

* `resize_linear`: `cv2.resize(..., INTER_LINEAR)` on uint8. Weights are
  rounded to 11 bits (INTER_RESIZE_COEF_BITS); the horizontal pass sums
  integers, and the vertical pass, as cv2's vector code computes it, shifts
  each row sum right by 4, takes the high 16 bits of its product with the
  row weight, adds the two and rounds away the last 2 bits. Columns past the
  edge take the edge pixel with weight 1; rows past the edge take the edge
  row with their own weights. A 2x downscale, which cv2 hands to its area
  code, comes out the same (each weight is exactly 1024).
* `resize_nearest`: `INTER_NEAREST`, source index floor(x / (dst / src)).
* `bgr_to_hsv`: `COLOR_BGR2HSV` on uint8 (H in [0, 180)), through cv2's
  division tables with a 12-bit shift.
* `hsv_to_bgr`: `COLOR_HSV2BGR` on uint8, in float32 as cv2 does, where
  `1 - s * h` is one fused multiply-add (computed here in float64, where the
  product of two float32 values is exact, and rounded once). cv2 converts
  row by row; its vector loop takes the first multiple of 32 pixels of a row
  and truncates the result to uint8, its scalar tail takes the rest and
  rounds.

The random draws of `sample_video_transform` are the JAX package's, in its
order, from the `RandomState` the caller passes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

RESIZE_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
HSV_SHIFT = 12  # cv2's hsv_shift
HUE_RANGE = 180  # H of an 8-bit HSV image
# pixels per iteration of cv2's vector loop for HSV -> BGR on uint8 (its AVX2
# build: 32 one-byte lanes)
HSV2BGR_VECTOR_PIXELS = 32


def _linear_taps(dst: int, src: int, clamp_weights: bool):
    """Source indices and 11-bit weights of one axis, as cv2 computes them:
    f = (i + 0.5) * scale - 0.5 in float32, weights round((1 - f) * 2048)
    and round(f * 2048). Along x (clamp_weights) a tap past either edge is
    the edge pixel with weight 1; along y the row index is clamped and the
    weights are kept."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    if clamp_weights:
        low, high = i0 < 0, i0 >= src - 1
        f = np.where(low | high, np.float32(0), f)
        i0 = np.where(low, 0, np.where(high, src - 1, i0))
    one = np.float32(1)
    w0 = np.rint((one - f) * np.float32(1 << RESIZE_COEF_BITS)).astype(np.int64)
    w1 = np.rint(f * np.float32(1 << RESIZE_COEF_BITS)).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, hw: Sequence[int]) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)` for a uint8
    [H, W] or [H, W, C] image."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, not {img.dtype}")
    dh, dw = int(hw[0]), int(hw[1])
    sh, sw = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(dw, sw, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(dh, sh, clamp_weights=False)
    extra = (1,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0.reshape(1, -1, *extra) + src[:, x1] * a1.reshape(1, -1, *extra)
    rows >>= 4
    b0, b1 = b0.reshape(-1, 1, *extra), b1.reshape(-1, 1, *extra)
    out = ((rows[y0] * b0) >> 16) + ((rows[y1] * b1) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, hw: Sequence[int]) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`."""
    dh, dw = int(hw[0]), int(hw[1])
    sh, sw = img.shape[:2]
    sy = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))).astype(np.int64), sh - 1)
    sx = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))).astype(np.int64), sw - 1)
    return img[sy][:, sx]


def _div_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i == 0, 0, np.rint((255 << HSV_SHIFT) / i))
        hdiv = np.where(i == 0, 0, np.rint((HUE_RANGE << HSV_SHIFT) / (6.0 * i)))
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


_SDIV, _HDIV = _div_tables()


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2HSV)` for a uint8 [..., 3] image."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + HUE_RANGE, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# per hue sector, the table entries (v, v(1-s), v(1-sh), v(1-s(1-h))) that
# become b, g, r
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)` for a uint8 [..., 3] image with
    H in [0, 180)."""
    f32, one = np.float32, np.float32(1)
    h = hsv[..., 0].astype(f32) * (f32(6) / f32(HUE_RANGE))
    s = hsv[..., 1].astype(f32) * f32(1 / 255)
    v = hsv[..., 2].astype(f32) * f32(1 / 255)
    sector = np.floor(h)
    h = h - sector
    s64 = s.astype(np.float64)

    def fma_one_minus(x):  # float32(1 - s * x) rounded once, as an FMA gives it
        return (1.0 - s64 * x.astype(np.float64)).astype(f32)

    tab = np.stack([v, v * (one - s), v * fma_one_minus(h), v * fma_one_minus(one - h)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1) * f32(255)
    # cv2 converts each row on its own: the vector loop truncates, the
    # scalar tail rounds
    vector = np.arange(hsv.shape[-2]) < hsv.shape[-2] // HSV2BGR_VECTOR_PIXELS \
        * HSV2BGR_VECTOR_PIXELS
    out = np.where(vector[:, None], np.trunc(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)


def _cvt(img: np.ndarray, alpha: float = 1.0, beta: float = 0.0) -> np.ndarray:
    """d2 ColorAugSSDTransform.convert: affine in float, clip, back to uint8."""
    return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)


def apply_ssd_color(img: np.ndarray, p: dict) -> np.ndarray:
    """SSD photometric distortion, d2's `ColorAugSSDTransform.apply_image`:
    in BGR, brightness first, then contrast before or after the saturation
    and hue pair; each sub-op round-trips through uint8, and saturation and
    hue each make their own BGR <-> HSV round trip."""
    out = img[:, :, ::-1]
    if p["brightness"] is not None:
        out = _cvt(out, beta=p["brightness"])

    def saturation_hue(out):
        if p["saturation"] is not None:
            hsv = bgr_to_hsv(out)
            hsv[:, :, 1] = _cvt(hsv[:, :, 1], alpha=p["saturation"])
            out = hsv_to_bgr(hsv)
        if p["hue"] is not None:
            hsv = bgr_to_hsv(out)
            hsv[:, :, 0] = (hsv[:, :, 0].astype(int) + p["hue"]) % HUE_RANGE
            out = hsv_to_bgr(hsv.astype(np.uint8))
        return out

    if p["contrast_first"]:
        if p["contrast"] is not None:
            out = _cvt(out, alpha=p["contrast"])
        out = saturation_hue(out)
    else:
        out = saturation_hue(out)
        if p["contrast"] is not None:
            out = _cvt(out, alpha=p["contrast"])
    return np.ascontiguousarray(out[:, :, ::-1])


class VideoTransform:
    """A sampled, replayable transform: resize -> crop -> colour -> flip."""

    def __init__(self, new_hw, crop_yx, crop_size, flip, color_params):
        self.new_hw = new_hw
        self.crop_yx = crop_yx
        self.crop_size = crop_size
        self.flip = flip
        self.color_params = color_params

    def apply_image(self, img: np.ndarray, color: bool = True) -> np.ndarray:
        out = self._crop(resize_linear(img, self.new_hw))
        if color and self.color_params is not None:
            out = apply_ssd_color(out, self.color_params)
        if self.flip:
            out = out[:, ::-1]
        return np.ascontiguousarray(out)

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        out = self._crop(resize_nearest(seg.astype(np.uint8), self.new_hw))
        if self.flip:
            out = out[:, ::-1]
        return np.ascontiguousarray(out)

    def _crop(self, x):
        if self.crop_yx is None:
            return x
        y, xx = self.crop_yx
        ch, cw = self.crop_size
        return x[y:y + ch, xx:xx + cw]


def sample_video_transform(rng: np.random.RandomState, hw, min_sizes: Sequence[int],
                           max_size: int, crop_size: Optional[tuple], color_aug: bool,
                           flip: bool) -> VideoTransform:
    """ResizeShortestEdge (a choice of short sides, the long side capped at
    `max_size`), an absolute random crop, d2's SSD colour draws (each sub-op
    with probability 1/2: brightness delta uniform(-32, 32), contrast and
    saturation uniform(0.5, 1.5), an integer hue delta in [-18, 18]) and a
    horizontal flip with probability 1/2."""
    h, w = hw
    short = int(min_sizes[rng.randint(len(min_sizes))])
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))

    crop_yx = csize = None
    if crop_size is not None:
        ch, cw = min(crop_size[0], nh), min(crop_size[1], nw)
        crop_yx = (rng.randint(nh - ch + 1), rng.randint(nw - cw + 1))
        csize = (ch, cw)

    color = None
    if color_aug:
        color = {
            "brightness": rng.uniform(-32, 32) if rng.rand() < 0.5 else None,
            "contrast": rng.uniform(0.5, 1.5) if rng.rand() < 0.5 else None,
            "contrast_first": bool(rng.rand() < 0.5),
            "saturation": rng.uniform(0.5, 1.5) if rng.rand() < 0.5 else None,
            "hue": int(rng.randint(-18, 19)) if rng.rand() < 0.5 else None,
        }
    return VideoTransform((nh, nw), crop_yx, csize, flip and rng.rand() < 0.5, color)
