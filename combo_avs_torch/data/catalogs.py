"""Dataset catalogs: walk the AVSBench S4 and MS3 directory layouts and
register per-video records.

Port of the S4 and MS3 parts of `combo_avs_tpu/data/catalogs.py`
(`load_avss4_records`, `load_avsms3_records`, `register_all`):
* S4 (ref: models/data/datasets/register_avss4_sem.py): visual_frames/
  <split>/<category>/<video>/*.png, gt_masks alike, audio_log_mel/<split>/
  <category>/<video>.pkl and pre_SAM_mask/<split>/<category>/<video>/
  *_mask_color.png; the train split annotates only the first frame
  (ref :18,49-52);
* MS3 (ref: register_avsms3_sem.py): the same without the category level,
  every frame annotated;
* AVSS (ref: register_avss_sem.py:25-121): `metadata.csv` (uid, label =
  the subset v1s / v1m / v2, split) and `label2idx.json` (the 71 class
  names), with <subset>/<uid>/processed_frames/*.png, index-label PNGs in
  processed_labels_semantic/, audio.pkl, and pre_SAM_mask/<subset>/<uid>/
  processed_frames/*_mask_color.png. v1s and v1m videos have 5 frames, v2
  videos 10 (ref :35-48); v1s train videos keep their first label only.
Records are plain dicts, equal key for key to the JAX package's. The JAX
package reads `metadata.csv` with pandas; the port with the `csv` module.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Dict, List, Optional

DatasetCatalog: Dict[str, Callable[[], List[dict]]] = {}
MetadataCatalog: Dict[str, dict] = {}

# S4 and MS3 alike
BINARY_METADATA = {"stuff_classes": ["background", "object"], "ignore_label": 255,
                   "evaluator_type": "sem_seg", "num_frames": 5}
AVSS_CLASSES = 71  # AVSBench-semantic: 70 sounding classes and the background


def register(name: str, fn: Callable[[], List[dict]], metadata: dict) -> None:
    DatasetCatalog[name] = fn
    MetadataCatalog[name] = metadata


def _png_sorted(d: str) -> List[str]:
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith((".png", ".jpg")))


def load_avss4_records(root: str, split: str, pre_mask_root: Optional[str] = None) -> List[dict]:
    """root: .../Single-source/s4_data. Returns one record per video."""
    frame_root = os.path.join(root, "visual_frames", split)
    records = []
    for category in sorted(os.listdir(frame_root)):
        cdir = os.path.join(frame_root, category)
        if not os.path.isdir(cdir):
            continue
        for video in sorted(os.listdir(cdir)):
            mask_dir = os.path.join(root, "gt_masks", split, category, video)
            masks = _png_sorted(mask_dir) if os.path.isdir(mask_dir) else []
            if split == "train":
                masks = masks[:1]  # only the first frame is annotated
            rec = {
                "video": video,
                "category": category,
                "file_names": _png_sorted(os.path.join(cdir, video)),
                "sem_seg_file_names": masks,
                "audio_file_name": os.path.join(root, "audio_log_mel", split, category,
                                                f"{video}.pkl"),
                "num_frames": 5,
                "gt_temporal_mask_flag": [1] + [0] * 4 if split == "train" else [1] * 5,
                "vid_temporal_mask_flag": [1] * 5,
            }
            if pre_mask_root:
                pdir = os.path.join(pre_mask_root, split, category, video)
                if os.path.isdir(pdir):
                    rec["pre_mask_file_names"] = [
                        p for p in _png_sorted(pdir) if p.endswith("_mask_color.png")]
            records.append(rec)
    return records


def load_avsms3_records(root: str, split: str, pre_mask_root: Optional[str] = None) -> List[dict]:
    """root: .../Multi-sources/ms3_data. Returns one record per video, all 5
    frames annotated."""
    frame_root = os.path.join(root, "visual_frames", split)
    records = []
    for video in sorted(os.listdir(frame_root)):
        vdir = os.path.join(frame_root, video)
        if not os.path.isdir(vdir):
            continue
        mask_dir = os.path.join(root, "gt_masks", split, video)
        rec = {
            "video": video,
            "file_names": _png_sorted(vdir),
            "sem_seg_file_names": _png_sorted(mask_dir) if os.path.isdir(mask_dir) else [],
            "audio_file_name": os.path.join(root, "audio_log_mel", split, f"{video}.pkl"),
            "num_frames": 5,
            "gt_temporal_mask_flag": [1] * 5,
            "vid_temporal_mask_flag": [1] * 5,
        }
        if pre_mask_root:
            pdir = os.path.join(pre_mask_root, split, video)
            if os.path.isdir(pdir):
                rec["pre_mask_file_names"] = [
                    p for p in _png_sorted(pdir) if p.endswith("_mask_color.png")]
        records.append(rec)
    return records


def load_avss_records(root: str, split: str, pre_mask_root: Optional[str] = None) -> List[dict]:
    """root: the AVSS directory holding metadata.csv, label2idx.json and
    <subset>/<video>/ directories. One record per video of `split`, in the
    order of metadata.csv; v1s and v1m videos keep their first 5 frames,
    v2 videos 10 (the frame and GT flags of ref: register_avss_sem.py:35-48)."""
    with open(os.path.join(root, "metadata.csv"), newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["split"] == split]
    records = []
    for row in rows:
        video, subset = row["uid"], row["label"]
        vdir = os.path.join(root, subset, video)
        img_dir = os.path.join(vdir, "processed_frames")
        lbl_dir = os.path.join(vdir, "processed_labels_semantic")
        frames = _png_sorted(img_dir) if os.path.isdir(img_dir) else []
        labels = _png_sorted(lbl_dir) if os.path.isdir(lbl_dir) else []
        if subset == "v1s":
            vid_flag = [1] * 5
            gt_flag = [1, 0, 0, 0, 0] if split == "train" else [1] * 5
            if split == "train":
                labels = labels[:1]  # a v1s train video annotates its first frame only
        elif subset == "v1m":
            vid_flag = gt_flag = [1] * 5
        else:  # v2
            vid_flag = gt_flag = [1] * 10
        rec = {
            "video": video,
            "subset": subset,
            "file_names": frames[:len(vid_flag)],
            "sem_seg_file_names": labels,
            "audio_file_name": os.path.join(vdir, "audio.pkl"),
            "num_frames": len(vid_flag),
            "gt_temporal_mask_flag": list(gt_flag),
            "vid_temporal_mask_flag": list(vid_flag),
        }
        if pre_mask_root:
            pdir = os.path.join(pre_mask_root, subset, video, "processed_frames")
            if os.path.isdir(pdir):
                rec["pre_mask_file_names"] = [
                    p for p in _png_sorted(pdir) if p.endswith("_mask_color.png")]
        records.append(rec)
    return records


def avss_metadata(root: str) -> dict:
    """The AVSS splits' metadata: the class names of label2idx.json (0..70
    without one), the AVSS evaluator and 10 frames."""
    classes = list(range(AVSS_CLASSES))
    path = os.path.join(root, "label2idx.json")
    if os.path.exists(path):
        with open(path) as f:
            classes = list(json.load(f).keys())
    return {"stuff_classes": classes, "ignore_label": 255, "evaluator_type": "sem_seg_ss",
            "num_frames": 10}


def _first_dir(*candidates: Optional[str]) -> Optional[str]:
    return next((c for c in candidates if c and os.path.isdir(c)), None)


def register_all(datasets_root: str) -> None:
    """Register avss4_sem_seg_{train,val,test}, avsms3_sem_seg_{train,val,
    test} and avss_sem_seg_{train,val,test}, with the pre-SAM Maskiges COMBO
    takes, under a dataset root: either a parent holding Single-source/
    s4_data, Multi-sources/ms3_data and AVSS (or AVSBench_semantic), or the
    reference's per-benchmark root that points at .../Single-source,
    .../Multi-sources or the AVSS directory itself (ref:
    register_avss4_sem.py:117-119, register_avss_sem.py:147-150)."""
    norm = datasets_root.rstrip("/")
    roots = {
        "avss4": (load_avss4_records, _first_dir(
            os.path.join(datasets_root, "Single-source", "s4_data"),
            os.path.join(norm, "s4_data") if norm.endswith("Single-source") else None)),
        "avsms3": (load_avsms3_records, _first_dir(
            os.path.join(datasets_root, "Multi-sources", "ms3_data"),
            os.path.join(norm, "ms3_data") if norm.endswith("Multi-sources") else None)),
        "avss": (load_avss_records, _first_dir(
            os.path.join(datasets_root, "AVSS"),
            os.path.join(datasets_root, "AVSBench_semantic"),
            norm if os.path.isfile(os.path.join(norm, "metadata.csv")) else None)),
    }
    for bench, (load, root) in roots.items():
        if root is None:
            continue
        pre = os.path.join(root, "pre_SAM_mask")
        meta = avss_metadata(root) if bench == "avss" else BINARY_METADATA
        for split in ("train", "val", "test"):
            # bind the loader, root and Maskige root now: they are the loop's
            # names, and a late-binding closure would give every benchmark's
            # records the last one's
            register(f"{bench}_sem_seg_{split}",
                     lambda s=split, f=load, r=root, p=pre: f(r, s, p), dict(meta))
