"""Benchmark metrics of AVSBench, numpy only.

The port's own copy of `combo_avs_tpu/evaluation/metrics.py` (the port
imports nothing of the JAX package):

* `mask_iou`: binarize foreground prob > 0.5; frames with empty GT count
  true negatives as intersection and all pixels as union
  (ref: models/evaluation/sem_seg_evaluation.py:66-92).
* `eval_fmeasure`: max over a 255-threshold precision/recall sweep with
  beta^2 = 0.3, skipping empty-GT frames (ref: sem_seg_evaluation.py:95-137),
  as an exact histogram and reverse cumulative sum; NaN predictions pass no
  threshold.
* `batch_miou_fscore`: AVSS per-class histogram IoU/F over `nclass` classes
  with per-class presence counts (ref: sem_seg_evaluation_ss.py:66-118).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

EPS = 1e-7


def mask_iou(pred: np.ndarray, target: np.ndarray, eps: float = EPS,
             ignore: np.ndarray = None) -> float:
    """pred: [N, H, W] foreground probabilities; target: [N, H, W] binary.

    `ignore` (optional [N, H, W] bool) excludes pixels (the ignore_label 255
    padding) from intersection and union; frames with no valid pixel are
    dropped from the average. With ignore=None this is the reference
    formula, which counts every pixel."""
    if pred.ndim != 3 or pred.shape != target.shape:
        raise ValueError(f"mask_iou: pred {pred.shape} and target {target.shape} must be "
                         "one [N, H, W] shape")
    N = pred.shape[0]
    p = (pred > 0.5).astype(np.int64)
    t = (target > 0).astype(np.int64)
    v = np.ones_like(t) if ignore is None else (~ignore.astype(bool)).astype(np.int64)
    num_pixels = v.sum(axis=(1, 2))

    inter = (p * t * v).sum(axis=(1, 2))
    union = (np.maximum(p, t) * v).sum(axis=(1, 2))
    no_obj = (t * v).sum(axis=(1, 2)) == 0
    inter_no_obj = ((1 - t) * (1 - p) * v).sum(axis=(1, 2))
    inter = np.where(no_obj, inter_no_obj, inter)
    union = np.where(no_obj, num_pixels, union)
    keep = num_pixels > 0
    n = max(int(keep.sum()), 1) if ignore is not None else N
    return float((inter[keep] / (union[keep] + eps)).sum() / n)


def eval_fmeasure(pred: np.ndarray, gt: np.ndarray, pr_num: int = 255,
                  ignore: np.ndarray = None) -> float:
    """Max-F over thresholds, averaged over non-empty-GT frames. Optional
    `ignore` [N, H, W] bool excludes pixels from the sweep."""
    N = pred.shape[0]
    beta2 = 0.3
    thresholds = np.linspace(0, 1 - 1e-10, pr_num, dtype=np.float64)

    avg_f = np.zeros(pr_num, np.float64)
    img_num = 0
    for i in range(N):
        g = (gt[i] > 0).astype(np.float64)
        p = pred[i].astype(np.float64).reshape(-1)
        gflat = g.reshape(-1)
        if ignore is not None:
            keep = ~ignore[i].astype(bool).reshape(-1)
            p, gflat = p[keep], gflat[keep]
        if gflat.size == 0 or gflat.mean() == 0.0:
            continue
        # bin each pixel at the largest threshold it still passes (p >=
        # thresholds[j] <=> idx >= j); true positives and predicted
        # positives per threshold are then reverse cumulative sums of 0/1
        # counts, exact in float64. The uniform grid gives the bin
        # arithmetically, with an exact correction at the boundaries. NaN
        # pixels pass no threshold (bin -1), like the dense sweep's
        # `NaN >= t == False`
        p[np.isnan(p)] = -1.0
        step = thresholds[1] - thresholds[0]
        idx = np.clip(np.floor(p / step), -1, pr_num - 1).astype(np.int64)
        hi = idx < pr_num - 1
        idx[hi & (p >= thresholds[np.minimum(idx + 1, pr_num - 1)])] += 1
        idx[(idx >= 0) & (p < thresholds[np.maximum(idx, 0)])] -= 1
        keep_bin = idx >= 0
        tp = np.bincount(idx[keep_bin], weights=gflat[keep_bin],
                         minlength=pr_num)[::-1].cumsum()[::-1]
        ycnt = np.bincount(idx[keep_bin], minlength=pr_num)[::-1].cumsum()[::-1]
        prec = tp / (ycnt + 1e-20)
        recall = tp / (gflat.sum() + 1e-20)
        with np.errstate(divide="ignore", invalid="ignore"):
            f = (1 + beta2) * prec * recall / (beta2 * prec + recall)
        avg_f += np.nan_to_num(f, nan=0.0)
        img_num += 1
    if img_num == 0:
        return 0.0
    return float((avg_f / img_num).max())


def _histc(values: np.ndarray, nbins: int, mini: float, maxi: float) -> np.ndarray:
    """torch.histc semantics: nbins equal bins over [mini, maxi], values
    outside excluded, value == maxi lands in the last bin."""
    v = values.reshape(-1).astype(np.float64)
    v = v[(v >= mini) & (v <= maxi)]
    width = (maxi - mini) / nbins
    idx = np.minimum(np.floor((v - mini) / width).astype(np.int64), nbins - 1)
    return np.bincount(idx, minlength=nbins).astype(np.float64)


def batch_miou_fscore(output: np.ndarray, target: np.ndarray, nclass: int,
                      beta2: float = 0.3,
                      ignore_label: int = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """output [N, C, H, W] class scores, target [N, H, W] int labels in
    [0, C-1]. Returns (iou_sum[C], fscore_sum[C], class_presence_count[C])
    summed over the N frames; `ignore_label` pixels are excluded from every
    histogram."""
    predict = output.argmax(axis=1).astype(np.float64) + 1
    tgt = target.astype(np.float64) + 1
    predict = predict * (tgt > 0)
    if ignore_label is not None:
        valid = target != ignore_label
        predict = predict * valid
        tgt = tgt * valid
    intersection = predict * (predict == tgt)

    ious = np.zeros(nclass, np.float64)
    fscores = np.zeros(nclass, np.float64)
    cls_count = np.zeros(nclass, np.float64)
    for i in range(target.shape[0]):
        area_inter = _histc(intersection[i], nclass, 1, nclass)
        area_pred = _histc(predict[i], nclass, 1, nclass)
        area_lab = _histc(tgt[i], nclass, 1, nclass)
        area_union = area_pred + area_lab - area_inter
        ious += area_inter / (2.220446049250313e-16 + area_union)
        cls_count[np.nonzero(area_union)[0]] += 1
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = area_inter / area_pred
            recall = area_inter / area_lab
            f = (1 + beta2) * precision * recall / (beta2 * precision + recall)
        fscores += np.nan_to_num(f, nan=0.0)
    return ious, fscores, cls_count
