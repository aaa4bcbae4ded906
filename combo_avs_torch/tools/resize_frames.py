"""Offline AVSS frame and label resizing to a fixed size.

Port of `combo_avs_tpu/tools/resize_frames.py` (ref:
avs_tools/process_avssimg2fixsize.py:12-41): with `--mode crop` (training
frames) the short side is resized to `size` and the centre cropped, with
`--mode resize` (evaluation) the frame is resized to size x size; labels
take nearest, frames linear interpolation. Writes `processed_frames` /
`processed_labels_semantic` next to each video's `frames` /
`labels_semantic`, each file in its own format: a PNG's pixels as the JAX
tool's cv2 writes them, a JPEG's bytes equal to cv2's (quality 95, 4:2:0).
numpy, the port's PNG and JPEG codecs and its cv2-exact resizes
(`data/transforms.py`), no cv2. An image keeps its channels as cv2's
IMREAD_UNCHANGED reads them: gray stays gray, colour and palette images
are RGB; PNGs with alpha or transparency, or of another bit depth, raise.

Usage:
  python -m combo_avs_torch.tools.resize_frames --root AVS_dataset/AVSS --mode crop
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from combo_avs_torch.data.image import JPEG_MAGIC, PNG_MAGIC, read_image
from combo_avs_torch.data.jpeg import jpeg_components, write_jpeg
from combo_avs_torch.data.png import png_color_type, write_png
from combo_avs_torch.data.transforms import resize_linear, resize_nearest


def _resize(img: np.ndarray, hw, is_mask: bool) -> np.ndarray:
    return (resize_nearest if is_mask else resize_linear)(img, hw)


def crop_resize(img: np.ndarray, size: int, is_mask: bool = False) -> np.ndarray:
    h, w = img.shape[:2]
    if w > h:
        oh, ow = size, int(1.0 * w * size / h)
    else:
        ow, oh = size, int(1.0 * h * size / w)
    img = _resize(img, (oh, ow), is_mask)
    h, w = img.shape[:2]
    x1 = int(round((w - size) / 2.0))
    y1 = int(round((h - size) / 2.0))
    return img[y1:y1 + size, x1:x1 + size]


def resize(img: np.ndarray, size: int, is_mask: bool = False) -> np.ndarray:
    return _resize(img, (size, size), is_mask)


def read_unchanged(path: str) -> np.ndarray:
    """An image as cv2.imread(IMREAD_UNCHANGED) holds it, in RGB order: [H, W]
    for a gray PNG or JPEG, [H, W, 3] for a colour or palette one."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_MAGIC):
        depth, ctype, trns = png_color_type(data, path)
        if depth != 8 or ctype not in (0, 2, 3) or trns:
            raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {ctype}"
                             f"{' with transparency' if trns else ''}: only 8-bit gray, RGB "
                             "and opaque palette images are resized")
        gray = ctype == 0
    elif data.startswith(JPEG_MAGIC):
        gray = jpeg_components(data, path) == 1
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    return read_image(path, gray=gray)


def write_like(path: str, img: np.ndarray) -> None:
    """Write by the extension, as cv2.imwrite does: JPEG at quality 95."""
    if path.lower().endswith((".jpg", ".jpeg")):
        write_jpeg(path, img, quality=95)
    else:
        write_png(path, np.ascontiguousarray(img))


def process_video_dir(vdir: str, size: int, mode: str) -> int:
    fn = crop_resize if mode == "crop" else resize
    jobs = [("frames", "processed_frames", False),
            ("labels_semantic", "processed_labels_semantic", True)]
    n = 0
    for src_name, dst_name, is_mask in jobs:
        src = os.path.join(vdir, src_name)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(vdir, dst_name)
        os.makedirs(dst, exist_ok=True)
        for f in sorted(os.listdir(src)):
            if not f.endswith((".png", ".jpg")):
                continue
            out = fn(read_unchanged(os.path.join(src, f)), size, is_mask)
            write_like(os.path.join(dst, f), out)
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--mode", choices=("crop", "resize"), default="crop")
    args = p.parse_args(argv)

    n = 0
    for dirpath, dirs, _ in os.walk(args.root):
        if "frames" in dirs or "labels_semantic" in dirs:
            n += process_video_dir(dirpath, args.size, args.mode)
    print(f"processed {n} images under {args.root}")
    return n


if __name__ == "__main__":
    main()
