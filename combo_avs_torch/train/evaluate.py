"""The evaluation loop: dataset records in, the reference's mIoU and
F-score out (S4 and MS3; AVSS's per-class means and their no-background
variants).

Port of the device half of `combo_avs_tpu/train/trainer.py::evaluate`
(ref: models/evaluation/evaluator.py:106-255 inference_on_dataset): the
loader's batches, bucketed by frame count and each bucket padded to whole
batches with duplicates that are computed but never scored; only the four model inputs go
to the card, copied from pinned host memory without blocking; the reference's
three timers (data, compute, eval) and its log lines; the per-video
postprocess and metrics inline or, with `COMBO_EVAL_PROCS=N`, on N worker
processes whose partial evaluators are merged; and the results written to
`<output_dir>/inference/<dataset>/sem_seg_evaluation.pth`. The split's
`evaluator_type` picks the evaluator and the mapper's labels: "sem_seg"
(S4, MS3: binary GT, `SemSegEvaluator`) or "sem_seg_ss" (AVSS: index labels,
`SemSegEvaluatorSS`). With `tta` the step is the multi-scale and flip
test-time augmentation (`train_step.py::make_tta_eval_step`), as the JAX
evaluate builds it when TEST.AUG.ENABLED; with `vis_dir` each scored
frame's argmax is written there as a coloured PNG (`save_prediction_vis`),
and the metrics are computed inline. A batch that
runs the card out of memory is computed again one video at a time
(`run_step`); `eval_settings` reads the size, precision and TTA from a
config.

The worker pool forks its workers before the loader's threads exist (spawn
would re-import the caller's `__main__`); the workers run numpy and CPU
torch only, on one thread, and never touch CUDA. A worker that returns
nothing within 600 s (a lock held across the fork) is
killed with the rest of the pool before the error is raised, so no child
outlives a failed evaluation.

With several ranks (`parallel/distributed.py`) each rank evaluates every
`world`-th record (`parallel/mesh.py::shard_records`), the evaluators'
sums are merged over the ranks before the metrics are taken, so every rank
returns the whole split's metrics, and only rank 0 writes the results file;
each rank writes its own videos' prediction PNGs.
"""

from __future__ import annotations

import collections
import logging
import multiprocessing
import os
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from combo_avs_torch.data.catalogs import DatasetCatalog, MetadataCatalog
from combo_avs_torch.data.loader import eval_loader
from combo_avs_torch.data.mappers import AVSS_MAX_INSTANCES, AVSSemanticDatasetMapper
from combo_avs_torch.evaluation.evaluator import (SemSegEvaluator, SemSegEvaluatorSS,
                                                  eval_video_partial, eval_video_partial_ss)
from combo_avs_torch.evaluation.postprocess import crop_and_resize_gt, sem_seg_postprocess
from combo_avs_torch.evaluation.visual import binary_color_map, save_mask_png, v2_pallete
from combo_avs_torch.parallel import distributed
from combo_avs_torch.parallel.mesh import shard_records
from combo_avs_torch.train.train_step import make_eval_step, make_tta_eval_step

logger = logging.getLogger("COMBO")

MODEL_INPUTS = ("images", "audio_log_mel", "pre_masks", "vid_temporal_mask")


def _worker_init() -> None:
    # a forked child must not use the parent's intra-op thread pool
    torch.set_num_threads(1)


class MetricPool:
    """`procs` forked workers running `eval_video_partial`; results are
    merged in submission order, at most `4 * procs` videos in flight."""

    def __init__(self, procs: int, timeout: float = 600.0):
        self.procs, self.timeout = procs, timeout
        with warnings.catch_warnings():
            # Python 3.12 warns on fork with threads alive (CUDA's, torch's);
            # the children run numpy and CPU torch only
            warnings.simplefilter("ignore", DeprecationWarning)
            self._pool = multiprocessing.get_context("fork").Pool(procs, initializer=_worker_init)
        self._pending: collections.deque = collections.deque()

    def submit(self, fn, *args) -> None:
        self._pending.append(self._pool.apply_async(fn, args))

    def drain(self, evaluator, keep: int = 0) -> None:
        """Merge finished results, oldest first, until `keep` are in flight."""
        while len(self._pending) > keep:
            res = self._pending.popleft()
            try:
                evaluator.merge(res.get(timeout=self.timeout))
            except multiprocessing.TimeoutError:
                self.kill()
                raise RuntimeError(
                    f"COMBO_EVAL_PROCS metric worker returned nothing within {self.timeout:.0f} s "
                    "(a lock held across fork?); its workers were killed. Re-run with "
                    "COMBO_EVAL_PROCS=0 to compute the metrics inline.") from None

    def kill(self) -> None:
        """Terminate every worker now and reap them."""
        self._pool.terminate()
        self._pool.join()

    def close(self) -> None:
        self._pool.close()
        self._pool.join()


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def run_step(step: Callable[[Dict], torch.Tensor], inputs: Dict[str, torch.Tensor]) -> np.ndarray:
    """`step(inputs)` on the host; when the card runs out of memory on a batch
    of several videos, the batch again one video at a time (the reference's
    retry_if_cuda_oom, maskformer_model.py:423-433;
    combo_avs_tpu/train/trainer.py:204-228). Only
    `torch.cuda.OutOfMemoryError` is caught, and a single video that does
    not fit raises it."""
    try:
        return step(inputs).cpu().numpy()
    except torch.cuda.OutOfMemoryError:
        B = inputs["images"].shape[0]
        if B == 1:
            raise
        logger.warning("eval step ran out of device memory at batch_size=%d; retrying one "
                       "video at a time", B)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return np.concatenate([step({k: v[b:b + 1] for k, v in inputs.items()}).cpu().numpy()
                               for b in range(B)])


def default_evaluator(dataset_name: str):
    """A fresh evaluator of the split's `evaluator_type`: S4/MS3's, or
    AVSS's over the split's classes."""
    meta = MetadataCatalog[dataset_name]
    etype = meta.get("evaluator_type")
    if etype == "sem_seg":
        return SemSegEvaluator()
    if etype == "sem_seg_ss":
        return SemSegEvaluatorSS(num_classes=len(meta["stuff_classes"]))
    raise NotImplementedError(f"{dataset_name}: no evaluator of type {etype!r}")


def evaluate(model: torch.nn.Module, dataset_name: str, batch_size: int = 1,
             max_videos: Optional[int] = None, bf16: bool = False, size: int = 224,
             output_dir: str = "", mapper: Optional[Callable[[Dict], Dict]] = None,
             evaluator=None, tta: Optional[Dict] = None,
             vis_dir: Optional[str] = None,
             world: Optional[distributed.World] = None) -> Tuple[Dict, Dict]:
    """Evaluate `model` (on its own device) over the registered dataset.
    Returns ({"sem_seg": metrics}, timing): metrics "mIoU" and "f_score"
    (AVSS adds "mIoU_noBg" and "f_score_noBg"), timing the wall, data,
    compute and eval seconds and the counts of real videos and frames.
    `size` is INPUT.SIZE_DIVISIBILITY, the padded frame size; `mapper`
    defaults to the split's eval mapper at that size (binary or index
    labels), `evaluator` to a fresh one of the split's type
    (`default_evaluator`). `tta` ({"scales": [...], "flip": bool}) runs
    `make_tta_eval_step`; `vis_dir` receives one `<video>_<t>.png` per
    scored frame (`save_prediction_vis`) and turns the `COMBO_EVAL_PROCS`
    pool off, as in the JAX package. `world` (default:
    `distributed.current()`): this rank scores its shard of the records and
    the metrics are merged over the ranks; the timing is this rank's, with
    the number of ranks."""
    world = world or distributed.current()
    evaluator = evaluator if evaluator is not None else default_evaluator(dataset_name)
    records = DatasetCatalog[dataset_name]()
    if max_videos:
        records = records[:max_videos]
    records = shard_records(records, world.rank, world.size)
    semantic = isinstance(evaluator, SemSegEvaluatorSS)
    pre_sam = getattr(model, "use_pre_sam", True)
    if mapper is None:
        mapper = (AVSSemanticDatasetMapper(size_divisibility=size, binary_gt=False,
                                           max_instances=AVSS_MAX_INSTANCES,
                                           use_pre_sam=pre_sam) if semantic
                  else AVSSemanticDatasetMapper(size_divisibility=size, use_pre_sam=pre_sam))
    if tta is not None:
        step = make_tta_eval_step(model, scales=tta["scales"], flip=tta["flip"],
                                  out_size=(size, size), bf16=bf16)
    else:
        step = make_eval_step(model, out_size=(size, size), bf16=bf16)
    device = next(model.parameters()).device
    if vis_dir:
        os.makedirs(vis_dir, exist_ok=True)

    # the vis dump needs each prediction here, so it keeps the metrics inline
    eval_procs = 0 if vis_dir else int(os.environ.get("COMBO_EVAL_PROCS", "0") or 0)
    pool = MetricPool(eval_procs) if eval_procs > 0 else None
    n_videos_total, n_done, n_pad, n_frames = len(records), 0, 0, 0
    t_compute = t_data = t_eval = 0.0
    t0 = t_mark = t_log = time.perf_counter()
    try:
        for batch, recs in eval_loader(records, mapper, batch_size=batch_size,
                                       pad=batch_size > 1):
            t_data += time.perf_counter() - t_mark
            tc = time.perf_counter()
            if pre_sam and "pre_masks" not in batch:
                raise ValueError(f"{dataset_name}: videos without pre-SAM Maskiges; COMBO "
                                 "needs them")
            inputs = {k: _to_device(batch[k], device) for k in MODEL_INPUTS if k in batch}
            sem = run_step(step, inputs)
            t_compute += time.perf_counter() - tc
            real = sum(not r.get("_pad") for r in recs)
            n_done, n_pad = n_done + real, n_pad + len(recs) - real
            now = time.perf_counter()
            if now - t_log >= 5.0 and n_done < n_videos_total:
                per_video = (now - t0) / n_done
                eta = int(per_video * (n_videos_total - n_done))
                logger.info("Inference done %d/%d. Dataloading: %.4f s/video. Inference: %.4f "
                            "s/video. Eval: %.4f s/video. Total: %.4f s/video. "
                            "ETA=%d:%02d:%02d", n_done, n_videos_total, t_data / n_done,
                            t_compute / n_done, t_eval / n_done, per_video, eta // 3600,
                            eta % 3600 // 60, eta % 60)
                t_log = now
            te = time.perf_counter()
            B, T = batch["images"].shape[:2]
            sem = sem.reshape(B, T, *sem.shape[1:])
            for b in range(B):
                if recs[b].get("_pad"):
                    continue
                hw = (int(batch["image_size"][b][0]), int(batch["image_size"][b][1]))
                oh, ow = int(batch["height"][b]), int(batch["width"][b])
                if pool is not None:
                    if semantic:
                        pool.submit(eval_video_partial_ss, evaluator.num_classes, sem[b],
                                    batch["sem_segs"][b], hw, oh, ow)
                    else:
                        pool.submit(eval_video_partial, sem[b], batch["sem_segs"][b], hw, oh,
                                    ow)
                    pool.drain(evaluator, keep=4 * eval_procs)
                    continue
                pred = sem_seg_postprocess(sem[b], hw, oh, ow)
                evaluator.process(pred, crop_and_resize_gt(batch["sem_segs"][b], hw, oh, ow))
                if vis_dir:
                    save_prediction_vis(vis_dir, recs[b]["video"], pred)
            n_frames += T * real
            t_eval += time.perf_counter() - te
            t_mark = time.perf_counter()
        if pool is not None:
            te = time.perf_counter()
            pool.drain(evaluator)
            pool.close()
            pool = None
            t_eval += time.perf_counter() - te
    finally:
        if pool is not None:  # an error above: no worker outlives it
            pool.kill()

    total = time.perf_counter() - t0
    if n_pad:
        logger.info("Eval padding: %d duplicate videos of %d total (%.1f%% of compute) to "
                    "fill batch_size=%d buckets", n_pad, n_done + n_pad,
                    100.0 * n_pad / (n_done + n_pad), batch_size)
    n_iter = max(n_frames, 1)
    for what, secs in (("inference", total), ("inference pure compute", t_compute),
                       ("eval (postprocess+metrics)", t_eval)):
        logger.info("Total %s time: %.6f s (%.6f s / iter per device, on %d devices)",
                    what, secs, secs / n_iter, world.size)
    results = distributed.merge_evaluator_across_hosts(evaluator, world).evaluate()
    if output_dir and world.main:
        inference_dir = os.path.join(output_dir, "inference", dataset_name)
        os.makedirs(inference_dir, exist_ok=True)
        torch.save(results["sem_seg"], os.path.join(inference_dir, "sem_seg_evaluation.pth"))
        print_csv_format(results)
    timing = {"total_s": total, "data_s": t_data, "compute_s": t_compute, "eval_s": t_eval,
              "videos": n_done, "frames": n_frames, "ranks": world.size}
    return results, timing


def save_prediction_vis(vis_dir: str, video: str, pred: np.ndarray) -> None:
    """One coloured PNG per frame, `<video>_<t>.png`, of pred [T, C, H, W]'s
    argmax over classes: with C = 2 the evaluator's own decision (fg score
    above bg <=> softmax fg > 0.5), so the dump agrees with the reported
    mIoU; the binary palette for C <= 2, `v2_pallete(C)` above
    (combo_avs_tpu/train/trainer.py:369-382)."""
    T, C = pred.shape[:2]
    palette = binary_color_map() if C <= 2 else v2_pallete(C)
    for t in range(T):
        save_mask_png(os.path.join(vis_dir, f"{video}_{t}.png"),
                      pred[t].argmax(0).astype(np.int32), palette)


def eval_settings(cfg, device: torch.device) -> Dict:
    """evaluate()'s keywords from a config: the padded size from
    INPUT.SIZE_DIVISIBILITY (224 when unset), the precision from TEST.BF16,
    where "auto" is bf16 on the card and fp32 on the CPU, and, when
    TEST.AUG.ENABLED, the test-time augmentation's scales and flip
    (TEST.AUG.MIN_SIZES, TEST.AUG.FLIP; TEST.AUG.MAX_SIZE is ignored, as in
    JAX) (combo_avs_tpu/train/trainer.py:185-196)."""
    bf16 = cfg.TEST.get("BF16", "auto")
    if bf16 == "auto":
        bf16 = device.type == "cuda"
    size = cfg.INPUT.SIZE_DIVISIBILITY if cfg.INPUT.SIZE_DIVISIBILITY > 0 else 224
    tta = ({"scales": [int(s) for s in cfg.TEST.AUG.MIN_SIZES], "flip": bool(cfg.TEST.AUG.FLIP)}
           if cfg.TEST.AUG.ENABLED else None)
    return {"size": size, "bf16": bool(bf16), "tta": tta}


def verify_results(results: Dict, expected: Sequence = ()) -> bool:
    """d2's verify_results: each [task, metric, expected, tolerance] of
    `expected` (the config's TEST.EXPECTED_RESULTS) must hold; raises
    AssertionError otherwise."""
    ok = True
    for task, metric, want, tolerance in expected:
        actual = results[task][metric]
        good = abs(actual - want) <= tolerance
        ok = ok and good
        logger.info("%s: %s = %.4f (expected %.4f +/- %.4f) %s", task, metric, actual, want,
                    tolerance, "OK" if good else "FAILED")
    if not ok:
        raise AssertionError(f"Result verification failed: {list(expected)}")
    if expected:
        logger.info("Results verification passed.")
    return ok


def print_csv_format(results: Dict) -> None:
    """d2's print_csv_format: greppable 'copypaste:' lines per task."""
    for task, metrics in results.items():
        logger.info("Evaluation results for %s:", task)
        logger.info("copypaste: Task: %s", task)
        logger.info("copypaste: %s", ",".join(metrics.keys()))
        logger.info("copypaste: %s", ",".join(f"{v:.4f}" for v in metrics.values()))
