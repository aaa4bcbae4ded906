"""The PyTorch port's training augmentation (`combo_avs_torch/data/
transforms.py`, numpy only) against cv2 and the JAX package's mapper
transforms on the CPU: uint8 resizes (linear and nearest, up and down, odd
sizes, the exact 2x downscale cv2 routes to its area code), BGR <-> HSV on
random pixels, greys, pure hues and the 0 / 255 extremes at row widths on
both sides of cv2's 32-pixel vector loop, each branch of the SSD colour
jitter against `combo_avs_tpu.data.mappers._apply_ssd_color`, and the
draws of `sample_video_transform`. Every comparison is byte equality."""

import cv2
import numpy as np
import pytest

from combo_avs_tpu.data import mappers as jax_mappers
from combo_avs_torch.data import transforms
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    one_torch_thread, release_worker_memory)

RESIZES = [  # (src h, w), (dst h, w)
    ((224, 224), (246, 246)), ((224, 224), (448, 448)), ((224, 224), (112, 112)),
    ((224, 224), (134, 134)), ((224, 224), (224, 224)), ((37, 53), (61, 29)),
    ((50, 50), (80, 83)), ((1, 7), (3, 2)), ((299, 171), (40, 401)), ((64, 64), (32, 32)),
]


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_resize_matches_cv2(src, dst, channels):
    rng = np.random.RandomState(sum(src) + sum(dst) + channels)
    img = rng.randint(0, 256, (*src, channels) if channels else src).astype(np.uint8)
    wh = (dst[1], dst[0])
    np.testing.assert_array_equal(transforms.resize_linear(img, dst),
                                  cv2.resize(img, wh, interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(transforms.resize_nearest(img, dst),
                                  cv2.resize(img, wh, interpolation=cv2.INTER_NEAREST))


def _colours(rng, width):
    """Random pixels plus greys, pure and mixed hues and the extremes,
    wrapped into rows of `width` pixels."""
    v = np.arange(256, dtype=np.uint8)
    z, f = np.zeros_like(v), np.full_like(v, 255)
    special = np.concatenate([
        np.stack([v, v, v], -1),  # greys, 0 and 255
        np.stack([v, z, z], -1), np.stack([z, v, z], -1), np.stack([z, z, v], -1),
        np.stack([f, v, z], -1), np.stack([v, f, z], -1), np.stack([z, f, v], -1),
        np.stack([z, v, f], -1), np.stack([v, z, f], -1), np.stack([f, z, v], -1),
    ])
    px = np.concatenate([special, rng.randint(0, 256, (20000, 3)).astype(np.uint8)])
    n = len(px) // width * width
    return px[:n].reshape(-1, width, 3)


@pytest.mark.parametrize("width", [1, 31, 32, 33, 224])
def test_hsv_round_trips_match_cv2(width):
    rng = np.random.RandomState(width)
    bgr = _colours(rng, width)
    hsv = transforms.bgr_to_hsv(bgr)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    hsv[..., 0] = rng.randint(0, 180, hsv.shape[:2])  # every hue, not only those reached
    np.testing.assert_array_equal(transforms.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_hsv_to_bgr_every_input_matches_cv2():
    """All 180 x 256 x 256 HSV bytes, in rows of 256 (cv2's vector loop) and
    in rows of 1 (its scalar code)."""
    for h0 in range(0, 180, 30):  # 30 hues at a time, to bound the memory
        hsv = np.stack(np.meshgrid(np.arange(h0, h0 + 30), np.arange(256), np.arange(256),
                                   indexing="ij"), -1).astype(np.uint8)
        for rows in (hsv.reshape(-1, 256, 3), hsv.reshape(-1, 1, 3)[::7]):
            rows = np.ascontiguousarray(rows)
            np.testing.assert_array_equal(transforms.hsv_to_bgr(rows),
                                          cv2.cvtColor(rows, cv2.COLOR_HSV2BGR))


NONE = dict(brightness=None, contrast=None, contrast_first=False, saturation=None, hue=None)
SSD_BRANCHES = {
    "brightness": dict(NONE, brightness=-17.25),
    "contrast_first": dict(NONE, contrast=1.37, contrast_first=True),
    "contrast_after": dict(NONE, contrast=0.61),
    "saturation": dict(NONE, saturation=1.43),
    "saturation_low": dict(NONE, saturation=0.52),
    "hue_up": dict(NONE, hue=17),
    "hue_down": dict(NONE, hue=-18),
    "all_contrast_first": dict(brightness=29.9, contrast=0.77, contrast_first=True,
                               saturation=0.58, hue=-5),
    "all_contrast_after": dict(brightness=-31.0, contrast=1.49, contrast_first=False,
                               saturation=1.21, hue=9),
}


@pytest.mark.parametrize("name", sorted(SSD_BRANCHES))
def test_ssd_colour_matches_jax(name):
    p = SSD_BRANCHES[name]
    rng = np.random.RandomState(len(name))
    for shape in ((224, 224, 3), (37, 45, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(transforms.apply_ssd_color(img, p),
                                      jax_mappers._apply_ssd_color(img, p))


def test_sample_video_transform_matches_jax():
    """The same draws in the same order: for 300 seeds the sampled
    transforms are equal and replay to the same bytes on a 224^2 frame, a
    Maskige (no colour) and a GT mask (nearest)."""
    min_sizes = tuple(int(x * 0.1 * 224) for x in range(5, 21))
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    gt = (rng.rand(224, 224) > 0.5).astype(np.uint8)
    for seed in range(300):
        args = ((224, 224), min_sizes, 896, (224, 224) if seed % 5 else None, seed % 7 != 0,
                seed % 11 != 0)
        a = jax_mappers.sample_video_transform(np.random.RandomState(seed), *args)
        b = transforms.sample_video_transform(np.random.RandomState(seed), *args)
        assert a.__dict__ == b.__dict__, seed
        if seed % 15 == 0:
            np.testing.assert_array_equal(b.apply_image(img), a.apply_image(img))
            np.testing.assert_array_equal(b.apply_image(img, color=False),
                                          a.apply_image(img, color=False))
            np.testing.assert_array_equal(b.apply_segmentation(gt), a.apply_segmentation(gt))
