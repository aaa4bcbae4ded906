"""Original-size eval postprocessing, without cv2.

Port of `combo_avs_tpu/evaluation/postprocess.py`. The reference crops the
model-resolution prediction back to the unpadded image region, then resizes
it bilinearly (align_corners=False) to the record's original (height, width)
before any metric is computed (d2 `sem_seg_postprocess`, ref:
models/maskformer_model.py:422-433). Both resizes run with
`F.interpolate` on CPU tensors: bilinear without antialiasing takes the same
half-pixel source coordinates and edge clamping as cv2's INTER_LINEAR, and
mode "nearest" the same floor(dst * in / out) index as INTER_NEAREST.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sem_seg_postprocess(
    result: np.ndarray,  # [C, H_pad, W_pad] or [N, C, H_pad, W_pad]
    img_size: Tuple[int, int],  # (h, w) valid region before padding
    output_height: int,
    output_width: int,
) -> np.ndarray:
    """Crop the padding, then resize bilinearly to the original size."""
    single = result.ndim == 3
    if single:
        result = result[None]
    h, w = int(img_size[0]), int(img_size[1])
    out = result[:, :, :h, :w]
    if (h, w) != (output_height, output_width):
        out = F.interpolate(torch.from_numpy(np.ascontiguousarray(out)),
                            size=(output_height, output_width), mode="bilinear",
                            align_corners=False, antialias=False).numpy()
    return out[0] if single else out


def crop_and_resize_gt(
    gt: np.ndarray,  # [N, H_pad, W_pad] int labels
    img_size: Tuple[int, int],
    output_height: int,
    output_width: int,
) -> np.ndarray:
    """Crop the ignore padding; nearest-neighbour resize (labels stay
    integral, as int32) when the original size differs."""
    h, w = int(img_size[0]), int(img_size[1])
    out = gt[:, :h, :w]
    if (h, w) != (output_height, output_width):
        # labels up to 255 are exact in float32
        x = torch.from_numpy(np.ascontiguousarray(out, np.float32))[:, None]
        out = F.interpolate(x, size=(output_height, output_width),
                            mode="nearest")[:, 0].numpy().astype(np.int32)
    return out
