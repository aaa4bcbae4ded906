"""Per-video dataset mapper: decode, augment (training), pad, build
static-shape targets.

Port of `combo_avs_tpu/data/mappers.py::AVSSemanticDatasetMapper.__call__`
for the three benchmarks (S4, MS3: ref: models/data/dataset_mappers/
avss4_semantic_dataset_mapper.py:60-240; AVSS: avss_semantic_dataset_mapper.py):

* frames, Maskiges and GT decoded from PNG or JPEG, by their content
  (`data/image.py::read_image`; AVSBench-semantic's frames are JPEG); a binary GT
  (S4, MS3) // 255 -> {0, 1} (ref :139), AVSS's index labels (0..70, 255
  ignored) as they are;
* in training, one transform per video (`data/transforms.py`: resize to a
  short side drawn from `min_sizes`, random crop, SSD colour jitter, flip),
  replayed on every frame; the Maskige takes it without the colour jitter,
  the GT with nearest-neighbour resizing (ref :70-95, :154-166). AVSS
  frames come resized offline, so its transform has no resize or crop,
  only the colour jitter and the flip (ref: avss_semantic_dataset_mapper.py:
  100-104);
* image and Maskige padded to `size_divisibility` with 128, GT with the
  ignore label 255 (ref :176-188);
* per-frame targets from the classes present, in K static slots with a
  valid mask (ref :196-230);
* the log-mel from the dataset's pickle (ref :61-66): a torch tensor in
  AVSBench, a numpy array in the synthetic tree.

Output per video (numpy, static shapes): images [T, S, S, 3] uint8 raw RGB,
pre_masks [T, S, S, 3] uint8, audio_log_mel [T, 96, 64] float32, labels
[T, K] int32, masks [T, K, S, S] bool, valid [T, K] bool, sem_segs [T, S, S]
uint8, gt_temporal_mask [T], vid_temporal_mask [T], image_size [2] (the
valid region after the transform), height, width.

The training transform of call n draws from
RandomState(SeedSequence([seed, n]).generate_state(1)[0]), as the JAX
mapper's does. The caller passes n (the training loader numbers its calls
by their place in the stream, so that the draws do not hang on which
worker thread runs first).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from combo_avs_torch.data.image import read_image
from combo_avs_torch.data.transforms import sample_video_transform

IGNORE_LABEL = 255  # MODEL.SEM_SEG_HEAD.IGNORE_VALUE
MAX_INSTANCES = 3  # target slots of the binary benchmarks (S4, MS3)
AVSS_MAX_INSTANCES = 12  # AVSS's (combo_avs_tpu/train/trainer.py:59-60)


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
    """The mapper of the three benchmarks, with the pre-SAM Maskiges COMBO
    takes. `size_divisibility` is INPUT.SIZE_DIVISIBILITY (224 for S4); 0
    keeps the frame's own size. With `is_train` and `augmentation` each video
    gets a sampled transform: `min_sizes` and `max_size` (INPUT.MIN_SIZE_TRAIN,
    MAX_SIZE_TRAIN), `crop_size` (INPUT.CROP.SIZE, None when the crop is off)
    and `color_aug` (INPUT.COLOR_AUG_SSD); the flip is always drawn; with
    `geometric_aug` off (AVSS) the transform keeps the frame's size and has
    no crop. `binary_gt` (S4, MS3) maps a 0/255 GT to {0, 1}; off (AVSS) the
    GT is index labels. The defaults are the shipped S4 recipe's
    (combo_avs_tpu/configs/avs_s4/R50-AVSS4-SemanticSegmentation.yaml:48-81)."""

    def __init__(self, size_divisibility: int = 224, is_train: bool = False,
                 augmentation: bool = True,
                 min_sizes: Sequence[int] = tuple(int(x * 0.1 * 224) for x in range(5, 21)),
                 max_size: int = 896, crop_size: Optional[Tuple[int, int]] = (224, 224),
                 color_aug: bool = True, ignore_label: int = IGNORE_LABEL,
                 max_instances: int = MAX_INSTANCES, binary_gt: bool = True,
                 geometric_aug: bool = True, seed: int = 0):
        self.size_divisibility = size_divisibility
        self.augmentation = augmentation and is_train
        self.min_sizes, self.max_size = tuple(min_sizes), max_size
        self.crop_size, self.color_aug = crop_size, color_aug
        self.ignore_label, self.max_instances = ignore_label, max_instances
        self.binary_gt, self.geometric_aug = binary_gt, geometric_aug
        self._seed = seed

    def __call__(self, record: Dict, n: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Map one video; `n`, the call number, is required in training."""
        if self.augmentation and n is None:
            raise ValueError("a training mapper needs the call number n")
        T = record["num_frames"]
        images = [read_image(p) for p in record["file_names"]]
        gts: List[Optional[np.ndarray]] = [None] * T
        for i, p in enumerate(record.get("sem_seg_file_names", [])[:T]):
            g = read_image(p, gray=True)
            gts[i] = (g // 255 if self.binary_gt else g).astype(np.uint8)
        pres = None
        if record.get("pre_mask_file_names"):
            pres = [read_image(p) for p in record["pre_mask_file_names"][:T]]

        tf = None
        if self.augmentation:
            rng = np.random.RandomState(
                np.random.SeedSequence([self._seed, n]).generate_state(1)[0])
            hw = images[0].shape[:2]
            if self.geometric_aug:
                tf = sample_video_transform(rng, hw, self.min_sizes, self.max_size,
                                            self.crop_size, self.color_aug, flip=True)
            else:  # the short side drawn from the frame's own: its size, no crop
                tf = sample_video_transform(rng, hw, [min(hw)], self.max_size, None,
                                            self.color_aug, flip=True)
        S = self.size_divisibility if self.size_divisibility > 0 else images[0].shape[0]
        # the valid (pre-padding) region after the video's transform, which
        # the prediction is cropped back to (ref: maskformer_model.py:411-433)
        if tf is not None:
            th, tw = tf.crop_size if tf.crop_size is not None else tf.new_hw
        else:
            th, tw = images[0].shape[:2]
        image_size = np.asarray([min(th, S), min(tw, S)], np.int32)
        out_images, out_pres, out_gts = [], [], []
        for i in range(T):
            img = images[i] if i < len(images) else np.zeros_like(images[0])
            if tf is not None:
                img = tf.apply_image(img)
            out_images.append(_pad_to(img, S, 128).astype(np.uint8))
            if pres is not None:
                pm = pres[i] if i < len(pres) else np.zeros_like(pres[0])
                if tf is not None:
                    pm = tf.apply_image(pm, color=False)
                out_pres.append(_pad_to(pm, S, 128).astype(np.uint8))
            g = gts[i]
            if g is not None:
                if tf is not None:
                    g = tf.apply_segmentation(g)
                g = _pad_to(g, S, self.ignore_label)
            out_gts.append(g)

        K = self.max_instances
        labels = np.zeros((T, K), np.int32)
        masks = np.zeros((T, K, S, S), bool)
        valid = np.zeros((T, K), bool)
        for i, g in enumerate(out_gts):
            if g is None:
                continue
            classes = np.unique(g)
            for k, c in enumerate(classes[classes != self.ignore_label][:K]):
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
            "sem_segs": np.stack([g if g is not None
                                  else np.full((S, S), self.ignore_label, np.uint8)
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
