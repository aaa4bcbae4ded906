"""Trainer: config -> model, criterion, optimizer and loaders -> the training
loop with periodic evaluation, the best checkpoint and resume.

Port of `combo_avs_tpu/train/trainer.py:417-620` (ref: train_net.py:65-226,
models/engine/hooks.py:14-101): one train step per iteration, evaluation
every TEST.EVAL_PERIOD iterations with the benchmark's evaluator,
`model_best.pth` kept on mIoU, a step checkpoint every
SOLVER.CHECKPOINT_PERIOD iterations and at the end, and the reference's
greppable log line (`s/iter`, `data_time`, `lr`). `metrics.jsonl` gets a row
per log line and per evaluation, the writers (`metrics.json`, TensorBoard)
the same scalars.

Each rank of the run (`parallel/distributed.py::World`; one rank unless the
process joined a group) drives one device, MODEL.DEVICE ("cuda" by default:
the current CUDA device, which the launcher sets to the rank's, raising
without one). Batches go to the card from pinned host memory without
blocking. The seed is cfg.SEED taken as the JAX trainer takes it
(`cfg.SEED or 0`, so the default -1 is the number -1, not d2's "random");
it seeds the model's init, the training generator (dropout and the
criterion's draws), the data order and the mapper's transforms (numpy takes
it modulo 2^32). The JAX trainer gives its loader no seed, so its data order
is seed 0's whatever cfg.SEED says; the port's follows the seed.

With several ranks, SOLVER.IMS_PER_BATCH stays the global batch, as in the
JAX package: each rank loads its slice of it (`TrainLoader`'s shards), the
step sums the gradients over the ranks (`train/train_step.py`), rank 0's
weights are broadcast before the first step, dropout draws from a
generator of the rank's own (seeded from cfg.SEED, the rank and the start
iteration), and the criterion's draws from the shared one that the step
checkpoints keep. Every rank evaluates its shard of each split and gets the
merged metrics, so the best-checkpoint decision is the same on all; only
rank 0 writes metrics.jsonl, the writers, `model_best.pth` and the step
checkpoints, and every rank waits at a barrier after each checkpoint, so a
resume on any rank reads a finished file.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from combo_avs_torch.data.catalogs import DatasetCatalog, MetadataCatalog
from combo_avs_torch.data.loader import TrainLoader
from combo_avs_torch.data.mappers import (AVSS_MAX_INSTANCES, MAX_INSTANCES,
                                          AVSSemanticDatasetMapper)
from combo_avs_torch.evaluation.evaluator import SemSegEvaluator, SemSegEvaluatorSS
from combo_avs_torch.losses.criterion import build_criterion, build_weight_dict
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import build_model
from combo_avs_torch.parallel import distributed
from combo_avs_torch.train.checkpoint import (BestCheckpointer, load_checkpoint, save_checkpoint,
                                              step_dirs)
from combo_avs_torch.train.evaluate import eval_settings, evaluate
from combo_avs_torch.train.optim import build_optimizer
from combo_avs_torch.train.train_step import make_train_step
from combo_avs_torch.utils.events import EventStorage, JSONWriter, TensorBoardWriter

logger = logging.getLogger("COMBO")

BINARY_MAPPERS = ("avss4_semantic", "avsms3_semantic")
MAPPERS = (*BINARY_MAPPERS, "avss_semantic")


def build_mapper(cfg, is_train: bool, seed: int = 0) -> AVSSemanticDatasetMapper:
    """The dataset mapper a config describes (trainer.py:52-71): S4 and MS3
    with binary GT and 3 target slots; AVSS with index labels, 12 slots and
    no geometric augmentation (its frames come resized); Maskiges only for
    a model with the SEM tower (MODEL.PRE_SAM.USE_PRE_SAM)."""
    name = cfg.INPUT.DATASET_MAPPER_NAME
    if name not in MAPPERS:
        raise NotImplementedError(f"INPUT.DATASET_MAPPER_NAME = {name!r} (the port has "
                                  f"{MAPPERS})")
    binary = name in BINARY_MAPPERS
    return AVSSemanticDatasetMapper(
        size_divisibility=cfg.INPUT.SIZE_DIVISIBILITY, is_train=is_train,
        augmentation=cfg.INPUT.AUGMENTATION, min_sizes=tuple(cfg.INPUT.MIN_SIZE_TRAIN),
        max_size=cfg.INPUT.MAX_SIZE_TRAIN,
        crop_size=tuple(cfg.INPUT.CROP.SIZE) if cfg.INPUT.CROP.ENABLED else None,
        color_aug=cfg.INPUT.COLOR_AUG_SSD, ignore_label=cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE,
        max_instances=MAX_INSTANCES if binary else AVSS_MAX_INSTANCES, binary_gt=binary,
        geometric_aug=binary, seed=seed % 2**32,
        use_pre_sam=cfg.MODEL.PRE_SAM.USE_PRE_SAM)


def build_evaluator(cfg, dataset_name: str):
    """The benchmark's evaluator (trainer.py:74-78): AVSS's over
    MODEL.SEM_SEG_HEAD.NUM_CLASSES classes for a "sem_seg_ss" split, else
    S4/MS3's."""
    etype = MetadataCatalog.get(dataset_name, {}).get("evaluator_type", "sem_seg")
    if etype == "sem_seg_ss":
        return SemSegEvaluatorSS(num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    return SemSegEvaluator()


def _pinned(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The loader's numpy batch as tensors, in page-locked memory when they
    go to the card, so that the step's copies do not block the host."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if device.type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


class Trainer:
    """DefaultTrainer's counterpart: `resume_or_load`, then `train` or
    `test`."""

    def __init__(self, cfg, device: Optional[torch.device | str] = None,
                 world: Optional[distributed.World] = None):
        self.cfg = cfg
        self.world = world or distributed.current()
        self.seed = int(cfg.get("SEED", 0) or 0)  # as the JAX trainer reads it (trainer.py:501)
        self.model = init_weights(build_model(cfg, device), seed=self.seed)
        self.device = next(self.model.parameters()).device
        self.criterion = build_criterion(cfg)
        self.weight_dict = build_weight_dict(cfg)
        self.optimizer = build_optimizer(cfg, self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.dropout_generator: Optional[torch.Generator] = None  # one rank: `generator`
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        self.best_ckpt = BestCheckpointer(cfg.OUTPUT_DIR, metric="mIoU")
        self.metrics_file = os.path.join(cfg.OUTPUT_DIR, "metrics.jsonl")
        self.storage = EventStorage()
        self.writers = [JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json")),
                        TensorBoardWriter(os.path.join(cfg.OUTPUT_DIR, "tb"))
                        ] if self.world.main else []
        self.start_iter = 0
        self.eval_timing: Dict[str, Dict] = {}  # each dataset's last evaluate() timing

    def _train_loader(self) -> TrainLoader:
        records = DatasetCatalog[self.cfg.DATASETS.TRAIN[0]]()
        return TrainLoader(records, build_mapper(self.cfg, is_train=True, seed=self.seed),
                           batch_size=self.cfg.SOLVER.IMS_PER_BATCH, seed=self.seed % 2**32,
                           num_workers=self.cfg.DATALOADER.NUM_WORKERS,
                           shard_index=self.world.rank, num_shards=self.world.size)

    def resume_or_load(self, resume: bool = False) -> None:
        """With `resume`, restore the newest `step_N` checkpoint under
        OUTPUT_DIR (weights, optimizer, generator) and start after its
        iteration; else keep the initialization (pretrained weights are the
        caller's: `train/checkpoint.py::load_pretrained`)."""
        steps = step_dirs(self.cfg.OUTPUT_DIR)
        if resume and steps:
            path = steps[max(steps)]
            logger.info("Resuming from %s", path)
            self.start_iter = load_checkpoint(path, self.model, self.optimizer, self.generator)

    def _log(self, it: int, max_iter: int, metrics: Dict[str, torch.Tensor], dt: float,
             ddt: float) -> None:
        loss = float(metrics["total_loss"])
        lr = self.optimizer.schedule(it)
        if not self.world.main:
            return
        logger.info("iter %d/%d total_loss %.4f lr %.2e (%.3f s/iter, data_time %.3f s/iter)",
                    it + 1, max_iter, loss, lr, dt, ddt)
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps({"iter": it + 1, "total_loss": loss, "lr": lr,
                                "s_per_iter": round(dt, 4), "data_time": round(ddt, 4)}) + "\n")
        self.storage.iter = it + 1
        self.storage.put_scalars(total_loss=loss, lr=lr, **{
            k: float(v) for k, v in metrics.items() if k != "total_loss"})
        for w in self.writers:
            w.write(self.storage)

    def train(self, max_iter: Optional[int] = None, log_every: int = 20) -> torch.nn.Module:
        """Iterations start_iter .. max_iter (SOLVER.MAX_ITER by default).
        s/iter counts the steps only: the clock restarts after each log line,
        evaluation and checkpoint; data_time is the wait on the loader."""
        cfg = self.cfg
        max_iter = max_iter or cfg.SOLVER.MAX_ITER
        world = self.world
        if world.size > 1:
            distributed.broadcast_module_(self.model, world)
            self.dropout_generator = torch.Generator(device=self.device).manual_seed(
                distributed.rank_seed(self.seed + self.start_iter, world.rank))
        step = make_train_step(self.model, self.criterion, self.weight_dict, self.optimizer,
                               self.generator, amp=cfg.SOLVER.AMP.ENABLED,
                               dropout_generator=self.dropout_generator, world=world)
        loader = self._train_loader()
        t0, n_timed, t_data = time.perf_counter(), 0, 0.0
        try:
            for it in range(self.start_iter, max_iter):
                td = time.perf_counter()
                batch = next(loader)
                t_data += time.perf_counter() - td
                metrics = step(_pinned(batch, self.device))
                n_timed += 1
                if (it + 1) % log_every == 0 or it + 1 == max_iter:
                    float(metrics["total_loss"])  # the step's end, before the clock is read
                    self._log(it, max_iter, metrics, (time.perf_counter() - t0) / n_timed,
                              t_data / n_timed)
                    t0, n_timed, t_data = time.perf_counter(), 0, 0.0
                paused = False
                if cfg.TEST.EVAL_PERIOD > 0 and (it + 1) % cfg.TEST.EVAL_PERIOD == 0:
                    self._eval_and_track(it + 1)
                    paused = True
                if (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or it + 1 == max_iter:
                    if world.main:
                        save_checkpoint(cfg.OUTPUT_DIR, self.model, self.optimizer,
                                        self.generator, it + 1)
                    world.barrier()
                    paused = True
                if paused:
                    t0, n_timed, t_data = time.perf_counter(), 0, 0.0
        finally:
            loader.close()
            for w in self.writers:
                w.close()
        return self.model

    def _eval_and_track(self, step: int) -> Dict:
        all_results = self.test()
        if "sem_seg" in all_results:
            all_results = {self.cfg.DATASETS.TEST[0]: all_results}
        primary = self.cfg.DATASETS.TEST[0]
        if not self.world.main:  # the merged metrics: rank 0 decides and writes for all
            return all_results[primary]
        # the best checkpoint follows the first test dataset
        improved = self.best_ckpt.update(all_results[primary], self.model, step)
        multi = len(all_results) > 1
        for name, results in all_results.items():
            logger.info("eval @ %d [%s]: %s%s", step, name, results["sem_seg"],
                        "  (new best)" if improved and name == primary else "")
            with open(self.metrics_file, "a") as f:
                row = {"iter": step, **results["sem_seg"]}
                if multi:
                    row["dataset"] = name
                f.write(json.dumps(row) + "\n")
            prefix = f"sem_seg/{name}/" if multi else "sem_seg/"
            self.storage.iter = step
            self.storage.put_scalars(**{prefix + k: v for k, v in results["sem_seg"].items()})
        for w in self.writers:
            w.write(self.storage)
        return all_results[primary]

    def test(self, dataset_name: Optional[str] = None, max_videos: Optional[int] = None,
             vis_dir: Optional[str] = None) -> Dict:
        """Evaluate one dataset, or every one of DATASETS.TEST ({dataset:
        results} when there are several), one video a batch as the JAX
        trainer does on one device, with the config's precision and
        test-time augmentation (`eval_settings`); results go to
        OUTPUT_DIR/inference/<dataset>/, and with `vis_dir` each frame's
        prediction to a PNG there (`save_prediction_vis`). With several
        ranks each scores its shard and all return the merged metrics."""
        names = [dataset_name] if dataset_name is not None else list(self.cfg.DATASETS.TEST)
        settings = eval_settings(self.cfg, self.device)
        results = {}
        for name in names:
            results[name], self.eval_timing[name] = evaluate(
                self.model, name, batch_size=1, max_videos=max_videos,
                output_dir=self.cfg.OUTPUT_DIR, mapper=build_mapper(self.cfg, is_train=False),
                evaluator=build_evaluator(self.cfg, name), vis_dir=vis_dir, world=self.world,
                **settings)
        return next(iter(results.values())) if len(results) == 1 else results
