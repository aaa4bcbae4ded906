"""Synthetic AVSBench S4, MS3 and AVSS trees on disk, written without cv2.

The S4 and AVSS parts of `scripts/make_synth_dataset.py` (`make_s4`,
`make_avss` and their helpers), with the port's PNG encoder: 5-frame videos
of frames, Maskiges, GT masks and pickled log-mels in the exact layout
`data/catalogs.py` walks (ref: models/data/datasets/register_avss4_sem.py:
17-58); `make_ms3`, the same videos in the MS3 layout (no category level,
all five frames annotated in every split; ref: register_avsms3_sem.py); and
`make_avss`, the AVSS layout (ref: register_avss_sem.py:25-121): a mix of
v1s, v1m (5 frames) and v2 (10 frames) videos whose GT is an index-label
PNG (the shape painted with one of the 70 sounding classes on background
0), listed in metadata.csv with label2idx.json beside it. The JAX script
writes train rows only; this one writes train, val and test rows. The content is
learnable, not noise: each of 10 categories is a (shape, colour, audio band)
triple drifting over a smooth textured background. The background is a
bicubic upsample of 14 x 14 noise, as the JAX package's script makes it,
though not bit for bit (PyTorch's bicubic, not cv2's).

    python -m combo_avs_torch.data.synth --root DIR [--s4-train 96] [--s4-val 48] \
        [--ms3-train 0] [--ms3-val 0] [--ms3-test 0] [--avss-train 0] [--avss-val 0] \
        [--avss-test 0] [--size 224]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from combo_avs_torch.data.png import write_png

N_CATEGORIES = 10
FRAME = 224


def _palette(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(40, 255, (n, 3)).astype(np.uint8)


CAT_COLORS = _palette(N_CATEGORIES, seed=7)
MASKIGE_COLORS = _palette(N_CATEGORIES + 1, seed=11)


def _background(rng: np.random.RandomState, size: int) -> np.ndarray:
    """A smooth textured background (PNG entropy like a photo's, unlike a
    flat fill): bicubic 14 x 14 noise plus fine noise, saturating at 255."""
    small = rng.randint(0, 256, (14, 14, 3), np.uint8)
    up = F.interpolate(torch.from_numpy(small).permute(2, 0, 1)[None].double(),
                       size=(size, size), mode="bicubic", align_corners=False)
    bg = up[0].permute(1, 2, 0).round().clamp(0, 255).numpy().astype(np.int32)
    noise = rng.randint(0, 25, (size, size, 3), np.uint8)
    return np.minimum(bg + noise, 255).astype(np.uint8)


def _shape_mask(cat: int, cx: int, cy: int, r: int, size: int) -> np.ndarray:
    """A filled disc (even categories) or square (odd ones), 255 inside."""
    yy, xx = np.mgrid[:size, :size]
    if cat % 2 == 0:
        inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    else:
        inside = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
    return inside.astype(np.uint8) * 255


def _video_frames(rng: np.random.RandomState, cat: int, T: int, size: int):
    """T frames of one video: the category's shape drifting over a fixed
    background. Returns (frames, masks_u8, maskiges)."""
    s = size / FRAME
    bg = _background(rng, size)
    cx, cy = rng.randint(int(60 * s), size - int(60 * s), 2)
    r = int(rng.randint(25, 55) * s)
    dx, dy = rng.randint(-4, 5, 2)
    color = CAT_COLORS[cat]
    frames, masks, maskiges = [], [], []
    for t in range(T):
        m = _shape_mask(cat, int(cx + dx * t * s), int(cy + dy * t * s), r, size)
        img = bg.copy()
        img[m > 0] = (0.85 * color + 0.15 * img[m > 0]).astype(np.uint8)
        mg = np.zeros((size, size, 3), np.uint8)
        mg[:] = MASKIGE_COLORS[-1] // 4  # dim background segment
        mg[m > 0] = MASKIGE_COLORS[cat]
        frames.append(img)
        masks.append(m)
        maskiges.append(mg)
    return frames, masks, maskiges


def _mel(rng: np.random.RandomState, cat: int, T: int) -> np.ndarray:
    """[T, 1, 96, 64] log-mel with a category-specific band."""
    mel = rng.randn(T, 1, 96, 64).astype(np.float32) * 0.3 - 3.0
    band = 4 + cat * 6
    mel[:, :, :, band:band + 5] += 2.5
    return mel


def _write(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, img)


def _make(data: str, n_train: int, n_val: int, size: int, by_category: bool,
          train_gt: int, n_test: int = 0) -> str:
    """Write train, val and test splits of 5-frame videos under `data`, in a
    category directory a video when `by_category`; train videos carry GT for
    their first `train_gt` frames, val and test videos for all five."""
    rng = np.random.RandomState(0)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        for v in range(n):
            cat_id = v % N_CATEGORIES
            vid = f"{split}_v{v:04d}"
            rel = os.path.join(split, f"cat{cat_id:02d}", vid) if by_category else os.path.join(
                split, vid)
            frames, masks, maskiges = _video_frames(rng, cat_id, 5, size)
            n_gt = train_gt if split == "train" else 5
            for t in range(5):
                name = f"{vid}_{t + 1}"
                _write(os.path.join(data, "visual_frames", rel, f"{name}.png"), frames[t])
                _write(os.path.join(data, "pre_SAM_mask", rel, f"{name}_mask_color.png"),
                       maskiges[t])
                if t < n_gt:
                    _write(os.path.join(data, "gt_masks", rel, f"{name}.png"), masks[t])
            mel_path = os.path.join(data, "audio_log_mel", f"{rel}.pkl")
            os.makedirs(os.path.dirname(mel_path), exist_ok=True)
            with open(mel_path, "wb") as f:
                pickle.dump(_mel(rng, cat_id, 5), f)
    return data


def make_s4(root: str, n_train: int, n_val: int, size: int = FRAME) -> str:
    """Write the S4 train and val splits under `root`; returns the s4_data
    directory. Train videos carry GT for their first frame only."""
    return _make(os.path.join(root, "Single-source", "s4_data"), n_train, n_val, size,
                 by_category=True, train_gt=1)


def make_ms3(root: str, n_train: int, n_val: int, size: int = FRAME, n_test: int = 0) -> str:
    """Write the MS3 train, val and test splits under `root`; returns the
    ms3_data directory. Every frame of every video carries GT."""
    return _make(os.path.join(root, "Multi-sources", "ms3_data"), n_train, n_val, size,
                 by_category=False, train_gt=5, n_test=n_test)


def make_avss(root: str, n_train: int, n_val: int, n_test: int = 0, size: int = FRAME) -> str:
    """Write the AVSS train, val and test splits under `root`; returns the
    AVSS directory. Video v of a split is a v1s, v1m or v2 video as v % 3
    is 0, 1 or 2 (5, 5 or 10 frames), of category v % 10, its shape painted
    with class 1 + v % 70; every frame carries its label (the catalog keeps a
    v1s train video's first)."""
    avss = os.path.join(root, "AVSS")
    os.makedirs(avss, exist_ok=True)
    with open(os.path.join(avss, "label2idx.json"), "w") as f:
        json.dump({f"class{i:02d}": i for i in range(71)}, f)
    rng = np.random.RandomState(1)
    rows = ["uid,label,split"]
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        for v in range(n):
            subset = ("v1s", "v1m", "v2")[v % 3]
            T = 10 if subset == "v2" else 5
            vid = f"{split}_{subset}_{v:04d}"
            cat_id = v % N_CATEGORIES
            cls = 1 + v % 70
            frames, masks, maskiges = _video_frames(rng, cat_id, T, size)
            vdir = os.path.join(avss, subset, vid)
            for t in range(T):
                _write(os.path.join(vdir, "processed_frames", f"{t}.png"), frames[t])
                _write(os.path.join(avss, "pre_SAM_mask", subset, vid, "processed_frames",
                                    f"{t}_mask_color.png"), maskiges[t])
                _write(os.path.join(vdir, "processed_labels_semantic", f"{t}.png"),
                       (masks[t] > 0).astype(np.uint8) * cls)
            with open(os.path.join(vdir, "audio.pkl"), "wb") as f:
                pickle.dump(_mel(rng, cat_id, T), f)
            rows.append(f"{vid},{subset},{split}")
    with open(os.path.join(avss, "metadata.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return avss


def main() -> None:
    ap = argparse.ArgumentParser(description="write synthetic AVSBench S4 and MS3 trees")
    ap.add_argument("--root", required=True)
    ap.add_argument("--s4-train", type=int, default=96)
    ap.add_argument("--s4-val", type=int, default=48)
    ap.add_argument("--ms3-train", type=int, default=0)
    ap.add_argument("--ms3-val", type=int, default=0)
    ap.add_argument("--ms3-test", type=int, default=0)
    ap.add_argument("--avss-train", type=int, default=0)
    ap.add_argument("--avss-val", type=int, default=0)
    ap.add_argument("--avss-test", type=int, default=0)
    ap.add_argument("--size", type=int, default=FRAME)
    args = ap.parse_args()
    if args.s4_train or args.s4_val:
        print(make_s4(args.root, args.s4_train, args.s4_val, args.size))
    if args.ms3_train or args.ms3_val or args.ms3_test:
        print(make_ms3(args.root, args.ms3_train, args.ms3_val, args.size, args.ms3_test))
    if args.avss_train or args.avss_val or args.avss_test:
        print(make_avss(args.root, args.avss_train, args.avss_val, args.avss_test, args.size))


if __name__ == "__main__":
    main()
