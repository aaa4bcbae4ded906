"""Maskige rendering: SAM instance masks -> the class-agnostic RGB prior image.

Port of `combo_avs_tpu/tools/maskige.py` (ref: avs_tools/pre_mask2rgb/
mask_precess_{s4,ms3,ss}.py, mask_precess_s4.py:100-143): the per-frame
instance masks sorted by area, ascending, composited into one id map (a
later mask fills only pixels still 0), resized to 224 nearest, and coloured
with the ADE20K 150-colour palette: the `*_mask_color.png` Maskige the SEM
tower reads. The file holds those RGB pixels (the JAX tool's docstring
says "indexed", but it writes RGB, and so does this one). numpy and the
port's PNG writer, no cv2.

Usage:
  python -m combo_avs_torch.tools.maskige --root <dir with per-frame .npy masks>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from combo_avs_torch.data.png import write_png
from combo_avs_torch.data.transforms import resize_nearest


def ade_palette() -> np.ndarray:
    """ADE20K 150-class palette, [150, 3] uint8 (same table the reference
    embeds, ref: mask_precess_s4.py:14-52)."""
    base = np.zeros((256, 3), np.uint8)
    colors = [
        [120, 120, 120], [180, 120, 120], [6, 230, 230], [80, 50, 50],
        [4, 200, 3], [120, 120, 80], [140, 140, 140], [204, 5, 255],
        [230, 230, 230], [4, 250, 7], [224, 5, 255], [235, 255, 7],
        [150, 5, 61], [120, 120, 70], [8, 255, 51], [255, 6, 82],
        [143, 255, 140], [204, 255, 4], [255, 51, 7], [204, 70, 3],
        [0, 102, 200], [61, 230, 250], [255, 6, 51], [11, 102, 255],
        [255, 7, 71], [255, 9, 224], [9, 7, 230], [220, 220, 220],
        [255, 9, 92], [112, 9, 255], [8, 255, 214], [7, 255, 224],
        [255, 184, 6], [10, 255, 71], [255, 41, 10], [7, 255, 255],
        [224, 255, 8], [102, 8, 255], [255, 61, 6], [255, 194, 7],
        [255, 122, 8], [0, 255, 20], [255, 8, 41], [255, 5, 153],
        [6, 51, 255], [235, 12, 255], [160, 150, 20], [0, 163, 255],
        [140, 140, 140], [250, 10, 15], [20, 255, 0], [31, 255, 0],
        [255, 31, 0], [255, 224, 0], [153, 255, 0], [0, 0, 255],
        [255, 71, 0], [0, 235, 255], [0, 173, 255], [31, 0, 255],
        [11, 200, 200], [255, 82, 0], [0, 255, 245], [0, 61, 255],
        [0, 255, 112], [0, 255, 133], [255, 0, 0], [255, 163, 0],
        [255, 102, 0], [194, 255, 0], [0, 143, 255], [51, 255, 0],
        [0, 82, 255], [0, 255, 41], [0, 255, 173], [10, 0, 255],
        [173, 255, 0], [0, 255, 153], [255, 92, 0], [255, 0, 255],
        [255, 0, 245], [255, 0, 102], [255, 173, 0], [255, 0, 20],
        [255, 184, 184], [0, 31, 255], [0, 255, 61], [0, 71, 255],
        [255, 0, 204], [0, 255, 194], [0, 255, 82], [0, 10, 255],
        [0, 112, 255], [51, 0, 255], [0, 194, 255], [0, 122, 255],
        [0, 255, 163], [255, 153, 0], [0, 255, 10], [255, 112, 0],
        [143, 255, 0], [82, 0, 255], [163, 255, 0], [255, 235, 0],
        [8, 184, 170], [133, 0, 255], [0, 255, 92], [184, 0, 255],
        [255, 0, 31], [0, 184, 255], [0, 214, 255], [255, 0, 112],
        [92, 255, 0], [0, 224, 255], [112, 224, 255], [70, 184, 160],
        [163, 0, 255], [153, 0, 255], [71, 255, 0], [255, 0, 163],
        [255, 204, 0], [255, 0, 143], [0, 255, 235], [133, 255, 0],
        [255, 0, 235], [245, 0, 255], [255, 0, 122], [255, 245, 0],
        [10, 190, 212], [214, 255, 0], [0, 204, 255], [20, 0, 255],
        [255, 255, 0], [0, 153, 255], [0, 41, 255], [0, 255, 204],
        [41, 0, 255], [41, 255, 0], [173, 0, 255], [0, 245, 255],
        [71, 0, 255], [122, 0, 255], [0, 255, 184], [0, 92, 255],
        [184, 255, 0], [0, 133, 255], [255, 214, 0], [25, 194, 194],
        [102, 255, 0], [92, 0, 255],
    ]
    base[: len(colors)] = np.asarray(colors, np.uint8)
    return base


def composite_instance_masks(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] binary instance masks -> [H, W] uint8 id map: sorted by
    area ascending; later (larger) masks fill only still-empty pixels."""
    if masks.ndim != 3 or masks.shape[0] == 0:
        return np.zeros(masks.shape[-2:] if masks.ndim == 3 else (640, 640), np.uint8)
    areas = masks.sum(axis=(1, 2))
    order = np.argsort(areas)
    m = masks[order[0]].astype(np.uint8)
    for idx in range(1, len(order)):
        m = np.where(m == 0, masks[order[idx]].astype(np.uint8) * (idx + 1), m)
    if m.max() > 255:
        raise ValueError("more than 255 instances")
    return m.astype(np.uint8)


def render_maskige(masks: np.ndarray, size: int = 224) -> np.ndarray:
    """Instance masks -> [size, size, 3] RGB Maskige."""
    m = resize_nearest(composite_instance_masks(masks), (size, size))
    return ade_palette()[m]


def load_masks(path: str) -> np.ndarray:
    """A frame's saved SAM masks as uint8; an unreadable array (a pickled
    empty result) is one blank 640 x 640 mask, as in the JAX tool."""
    arr = np.load(path, allow_pickle=True)
    try:
        arr[0].dtype
    except Exception:
        arr = np.zeros((1, 640, 640))
    return arr.astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="tree containing per-frame .npy SAM masks")
    p.add_argument("--size", type=int, default=224)
    args = p.parse_args(argv)

    n = 0
    for dirpath, _, files in os.walk(args.root):
        for f in sorted(files):
            if not f.endswith(".npy"):
                continue
            rgb = render_maskige(load_masks(os.path.join(dirpath, f)), args.size)
            write_png(os.path.join(dirpath, f[: -len(".npy")] + "_mask_color.png"), rgb)
            n += 1
    print(f"rendered {n} maskiges under {args.root}")
    return n


if __name__ == "__main__":
    main()
