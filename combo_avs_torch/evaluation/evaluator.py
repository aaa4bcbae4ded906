"""The dataset evaluators with the reference's reset / process / evaluate
protocol, and the per-video units of work of the metric pool.

Port of `combo_avs_tpu/evaluation/evaluator.py`:
* `SemSegEvaluator` (S4 / MS3; ref: models/evaluation/sem_seg_evaluation.py:
  140-281): per video, softmax the 2-channel semantic maps once more (the
  reference applies softmax on top of the model's softmax-x-sigmoid output,
  ref :243, kept for metric parity), take the foreground channel, accumulate
  per-video mask IoU and max-F; `evaluate()` means over videos;
* `SemSegEvaluatorSS` (AVSS; ref: sem_seg_evaluation_ss.py:214-283): the
  same extra softmax over the 71 classes, then per-class sums of IoU and
  F-score and per-class presence counts over frames (`batch_miou_fscore`);
  `evaluate()` divides each class's sums by its count (a class never
  present scores 0) and means over the classes, with and without the last
  one (the `_noBg` metrics);
* `eval_video_partial` and `eval_video_partial_ss`: one video's postprocess
  and metrics as a fresh evaluator, merged by the caller.
Numpy only, apart from the resize of `postprocess`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from combo_avs_torch.evaluation.metrics import batch_miou_fscore, eval_fmeasure, mask_iou
from combo_avs_torch.evaluation.postprocess import crop_and_resize_gt, sem_seg_postprocess


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def eval_video_partial(sem: np.ndarray, gt: np.ndarray, img_size, out_h: int,
                       out_w: int) -> "SemSegEvaluator":
    """Postprocess and metric math for one video, returned as a fresh
    evaluator holding the partial sums, which the caller merges: the unit of
    work of the process-parallel eval (`COMBO_EVAL_PROCS`,
    `train/evaluate.py`), for S4 and MS3; the JAX package's twin takes the
    evaluator's kind and class count (`eval_video_partial_ss` is the AVSS
    kind)."""
    ev = SemSegEvaluator()
    pred = sem_seg_postprocess(sem, img_size, out_h, out_w)
    ev.process(pred, crop_and_resize_gt(np.asarray(gt), img_size, out_h, out_w))
    return ev


def eval_video_partial_ss(num_classes: int, sem: np.ndarray, gt: np.ndarray, img_size,
                          out_h: int, out_w: int) -> "SemSegEvaluatorSS":
    """`eval_video_partial` for AVSS: a fresh `SemSegEvaluatorSS` holding
    one video's per-class sums."""
    ev = SemSegEvaluatorSS(num_classes=num_classes)
    pred = sem_seg_postprocess(sem, img_size, out_h, out_w)
    ev.process(pred, crop_and_resize_gt(np.asarray(gt), img_size, out_h, out_w))
    return ev


class SemSegEvaluator:
    """S4 / MS3: binary sounding-object masks."""

    def __init__(self, ignore_label: int = 255):
        self.ignore_label = ignore_label
        self.reset()

    def reset(self):
        self._miou_sum = 0.0
        self._f_sum = 0.0
        self._count = 0

    def process(self, sem_seg: np.ndarray, gt: np.ndarray):
        """sem_seg: [N, 2, H, W] model semantic maps for one video's frames;
        gt: [N, H, W] binary ground truth (ignore_label pixels excluded)."""
        gt = np.asarray(gt)
        ignore = gt == self.ignore_label
        if not ignore.any():
            ignore = None  # the reference formula on clean inputs
        probs = _softmax(np.asarray(sem_seg, np.float64), axis=1)[:, 1]
        self._miou_sum += mask_iou(probs, gt, ignore=ignore)
        self._f_sum += eval_fmeasure(probs, gt, ignore=ignore)
        self._count += 1

    def merge(self, other: "SemSegEvaluator"):
        self._miou_sum += other._miou_sum
        self._f_sum += other._f_sum
        self._count += other._count

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        n = max(self._count, 1)
        return {"sem_seg": {"mIoU": round(self._miou_sum / n, 4),
                            "f_score": round(self._f_sum / n, 4)}}


class SemSegEvaluatorSS:
    """AVSS: semantic masks of `num_classes` classes (71), each class's IoU
    and F-score normalized by the frames where it is present."""

    def __init__(self, num_classes: int = 71, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.reset()

    def reset(self):
        self._iou_pc = np.zeros(self.num_classes, np.float64)
        self._f_pc = np.zeros(self.num_classes, np.float64)
        self._cls_pc = np.zeros(self.num_classes, np.float64)

    def process(self, sem_seg: np.ndarray, gt: np.ndarray):
        """sem_seg: [N, C, H, W] class scores for one video's frames; gt:
        [N, H, W] int labels (ignore_label pixels excluded)."""
        probs = _softmax(np.asarray(sem_seg, np.float64), axis=1)
        iou, f, cls = batch_miou_fscore(probs, np.asarray(gt), self.num_classes,
                                        ignore_label=self.ignore_label)
        self._iou_pc += iou
        self._f_pc += f
        self._cls_pc += cls

    def merge(self, other: "SemSegEvaluatorSS"):
        self._iou_pc += other._iou_pc
        self._f_pc += other._f_pc
        self._cls_pc += other._cls_pc

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        with np.errstate(divide="ignore", invalid="ignore"):
            miou_pc = np.nan_to_num(self._iou_pc / self._cls_pc, nan=0.0)
            f_pc = np.nan_to_num(self._f_pc / self._cls_pc, nan=0.0)
        return {"sem_seg": {"mIoU": round(float(miou_pc.mean()), 4),
                            "f_score": round(float(f_pc.mean()), 4),
                            "mIoU_noBg": round(float(miou_pc[:-1].mean()), 4),
                            "f_score_noBg": round(float(f_pc[:-1].mean()), 4)}}
