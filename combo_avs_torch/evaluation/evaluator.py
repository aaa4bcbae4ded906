"""The S4 / MS3 dataset evaluator with the reference's reset / process /
evaluate protocol, and the per-video unit of work of the metric pool.

Port of `combo_avs_tpu/evaluation/evaluator.py` (`SemSegEvaluator`,
`eval_video_partial` for kind "sem_seg"; ref:
models/evaluation/sem_seg_evaluation.py:140-281): per video, softmax the
2-channel semantic maps once more (the reference applies softmax on top of
the model's softmax-x-sigmoid output, ref :243, kept for metric parity), take
the foreground channel, accumulate per-video mask IoU and max-F;
`evaluate()` means over videos. Numpy only, apart from the resize of
`postprocess`. The AVSS evaluator (`SemSegEvaluatorSS`) is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from combo_avs_torch.evaluation.metrics import eval_fmeasure, mask_iou
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
    `train/evaluate.py`). The JAX package's twin also takes the AVSS
    evaluator's kind and class count; only the S4/MS3 kind is ported."""
    ev = SemSegEvaluator()
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
