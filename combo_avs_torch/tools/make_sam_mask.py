"""SAM pre-mask generation (offline).

Port of `combo_avs_tpu/tools/make_sam_mask.py` (ref:
avs_tools/pre_mask/make_SAM_mask.py:64-79): a SAM automatic mask generator
on every frame, each frame's instance masks saved as an [N, H, W] uint8
.npy, which `combo_avs_torch.tools.maskige` renders into Maskiges. SAM is
not part of the port: the CLI needs the `segment_anything` package and a
checkpoint, and exits with the JAX tool's message when the package is
missing. Frames are read with the port's PNG/JPEG readers, no cv2.

Usage:
  python -m combo_avs_torch.tools.make_sam_mask --root <frames dir> \
      --checkpoint sam_vit_h.pth [--model-type vit_h]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from combo_avs_torch.data.image import read_image

MISSING = ("segment_anything is not installed in this image. Install it (and a "
           "SAM checkpoint) to generate pre-masks, or reuse the dataset's "
           "published pre_SAM_mask directory.")


def masks_to_array(sam_masks) -> np.ndarray:
    """A list of SAM mask dicts -> [N, H, W] uint8 stack."""
    if not sam_masks:
        return np.zeros((0, 0, 0), np.uint8)
    return np.stack([m["segmentation"].astype(np.uint8) for m in sam_masks])


def build_generator(checkpoint: str, model_type: str):
    try:
        from segment_anything import SamAutomaticMaskGenerator, sam_model_registry
    except ImportError as e:
        raise SystemExit(MISSING) from e
    sam = sam_model_registry[model_type](checkpoint=checkpoint)
    return SamAutomaticMaskGenerator(sam)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="tree of frame pngs")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model-type", default="vit_h")
    args = p.parse_args(argv)

    gen = build_generator(args.checkpoint, args.model_type)
    n = 0
    for dirpath, _, files in os.walk(args.root):
        for f in sorted(files):
            if not f.endswith((".png", ".jpg")):
                continue
            masks = gen.generate(read_image(os.path.join(dirpath, f)))
            np.save(os.path.join(dirpath, os.path.splitext(f)[0] + ".npy"),
                    masks_to_array(masks))
            n += 1
    print(f"wrote {n} mask arrays under {args.root}")
    return n


if __name__ == "__main__":
    main()
