"""Per-video dataset mapper for evaluation: decode, pad, build static-shape
targets.

Port of the eval branch of `combo_avs_tpu/data/mappers.py::
AVSSemanticDatasetMapper.__call__` (no augmentation; ref:
models/data/dataset_mappers/avss4_semantic_dataset_mapper.py:60-240):

* frames, Maskiges and GT decoded from PNG (`data/png.py`); GT // 255 ->
  {0, 1} (S4 and MS3, ref :139; AVSS's index labels are not ported);
* image and Maskige padded to `size_divisibility` with 128, GT with the
  ignore label 255 (ref :176-188);
* per-frame targets from the classes present, in K static slots with a
  valid mask (ref :196-230);
* the log-mel from the dataset's pickle (ref :61-66): a torch tensor in
  AVSBench, a numpy array in the synthetic tree.

Output per video (numpy, static shapes): images [T, S, S, 3] uint8 raw RGB,
pre_masks [T, S, S, 3] uint8, audio_log_mel [T, 96, 64] float32, labels
[T, K] int32, masks [T, K, S, S] bool, valid [T, K] bool, sem_segs [T, S, S]
uint8, gt_temporal_mask [T], vid_temporal_mask [T], image_size [2], height,
width. Training augmentation (resize, crop, SSD colour jitter, flip) is not
ported yet.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from combo_avs_torch.data.png import read_png

IGNORE_LABEL = 255  # MODEL.SEM_SEG_HEAD.IGNORE_VALUE
MAX_INSTANCES = 3  # target slots of the binary benchmarks (S4, MS3)


def _pad_to(x: np.ndarray, size: int, value: float) -> np.ndarray:
    h, w = x.shape[:2]
    if h >= size and w >= size:
        return x[:size, :size]
    pad = [(0, max(0, size - h)), (0, max(0, size - w))] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pad, constant_values=value)


def load_audio(path: str) -> np.ndarray:
    """The dataset's pickled log-mel (a torch tensor or a numpy array) as
    float32 [T, 96, 64]. Dataset files are trusted input: unpickling runs
    whatever the file holds."""
    with open(path, "rb") as f:
        mel = pickle.load(f)
    mel = np.asarray(mel.detach().numpy() if hasattr(mel, "detach") else mel, np.float32)
    return mel.reshape(mel.shape[0], 96, 64)


class AVSSemanticDatasetMapper:
    """The eval mapper of the binary benchmarks (S4, MS3), with the pre-SAM
    Maskiges COMBO takes. `size_divisibility` is INPUT.SIZE_DIVISIBILITY
    (224 for S4); 0 keeps the frame's own size."""

    def __init__(self, size_divisibility: int = 224):
        self.size_divisibility = size_divisibility

    def __call__(self, record: Dict) -> Dict[str, np.ndarray]:
        T = record["num_frames"]
        images = [read_png(p) for p in record["file_names"]]
        gts: List[Optional[np.ndarray]] = [None] * T
        for i, p in enumerate(record.get("sem_seg_file_names", [])[:T]):
            gts[i] = (read_png(p, gray=True) // 255).astype(np.uint8)
        pres = None
        if record.get("pre_mask_file_names"):
            pres = [read_png(p) for p in record["pre_mask_file_names"][:T]]

        S = self.size_divisibility if self.size_divisibility > 0 else images[0].shape[0]
        th, tw = images[0].shape[:2]
        # the valid (pre-padding) region, which the prediction is cropped
        # back to (ref: maskformer_model.py:411-433)
        image_size = np.asarray([min(th, S), min(tw, S)], np.int32)
        out_images, out_pres, out_gts = [], [], []
        for i in range(T):
            img = images[i] if i < len(images) else np.zeros_like(images[0])
            out_images.append(_pad_to(img, S, 128).astype(np.uint8))
            if pres is not None:
                pm = pres[i] if i < len(pres) else np.zeros_like(pres[0])
                out_pres.append(_pad_to(pm, S, 128).astype(np.uint8))
            g = gts[i]
            out_gts.append(None if g is None else _pad_to(g, S, IGNORE_LABEL))

        K = MAX_INSTANCES
        labels = np.zeros((T, K), np.int32)
        masks = np.zeros((T, K, S, S), bool)
        valid = np.zeros((T, K), bool)
        for i, g in enumerate(out_gts):
            if g is None:
                continue
            classes = np.unique(g)
            for k, c in enumerate(classes[classes != IGNORE_LABEL][:K]):
                labels[i, k] = c
                masks[i, k] = g == c
                valid[i, k] = True

        mel = load_audio(record["audio_file_name"])
        if mel.shape[0] < T:
            mel = np.pad(mel, ((0, T - mel.shape[0]), (0, 0), (0, 0)))
        out = {
            "images": np.stack(out_images),
            "audio_log_mel": mel[:T].astype(np.float32),
            "labels": labels,
            "masks": masks,
            "valid": valid,
            "gt_temporal_mask": np.asarray(record["gt_temporal_mask_flag"], np.float32)[:T],
            "vid_temporal_mask": np.asarray(record["vid_temporal_mask_flag"], np.float32)[:T],
            "sem_segs": np.stack([g if g is not None else np.full((S, S), IGNORE_LABEL, np.uint8)
                                  for g in out_gts]),
            # original-size postprocess inputs (ref: maskformer_model.py:
            # 417-419 reads height/width from the record, defaulting to the
            # unpadded image size)
            "image_size": image_size,
            "height": np.int32(record.get("height", image_size[0])),
            "width": np.int32(record.get("width", image_size[1])),
        }
        if out_pres:
            out["pre_masks"] = np.stack(out_pres)
        return out
