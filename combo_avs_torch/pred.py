"""Evaluation command line for COMBO-R50 and COMBO-PVTv2-B5: a reference
checkpoint over AVSBench S4, MS3 or AVSS splits, printing each split's mIoU
and F-score (AVSS: also without the background class).

The counterpart of the repository's `pred.py` (ref: pred.py:130-238) for
the PyTorch port. With `--config-file` the model is the one the config
describes (`models/meta_arch.py::build_model`), and the config says how to
evaluate, as the JAX `pred.py` reads it: every split of DATASETS.TEST, each
with its benchmark's mapper and evaluator (`train/trainer.py::build_mapper`,
`build_evaluator`), frames padded to INPUT.SIZE_DIVISIBILITY, the precision
of TEST.BF16 ("auto": bf16 on the card, fp32 on the CPU), the multi-scale
and flip test-time augmentation when TEST.AUG.ENABLED (TEST.AUG.MIN_SIZES,
TEST.AUG.FLIP), and the results checked against TEST.EXPECTED_RESULTS
(`verify_results`). Trailing `KEY VALUE` pairs override the config's keys,
as in the JAX `pred.py` (e.g. `TEST.AUG.ENABLED True`). `--dataset` and
`--bf16` override the config's splits and precision. `--save-vis` writes
each frame's prediction as a coloured PNG to `<out>/vis/<dataset>/`, where
`<out>` is `--output-dir`, else the config's OUTPUT_DIR. Without a config
the model is `MaskFormer()`'s defaults, COMBO-R50 S4, at 224, on
`--dataset` (avss4_sem_seg_test by default), fp32 unless `--bf16`, and no
overrides are taken.

    python -m combo_avs_torch.pred --datasets-root DIR --checkpoint model_best.pth \
        [--config-file combo_avs_tpu/configs/avs_ss/Test_COMBO_R50_bs8_90k.yaml] \
        [--dataset avss4_sem_seg_test | avsms3_sem_seg_test | avss_sem_seg_test | ...] \
        [--max-videos N] [--batch-size 4] [--bf16] [--output-dir DIR] [--device cpu] \
        [--save-vis] [--num-devices N] [KEY VALUE ...]

It runs on the current CUDA device unless `--device` names another. With
`--num-devices N` it runs N ranks on this machine (rank i on `cuda:i`, or
all on the CPU with `--device cpu`), each scoring every N-th video of each
split; the metrics are merged over the ranks and rank 0 prints them and
writes the results (`train/evaluate.py`). Trees
to try it on: `python -m combo_avs_torch.data.synth --root DIR [--ms3-val N]
[--avss-test N]` (their splits are `avss4_sem_seg_val`, `avsms3_sem_seg_val`
and `avss_sem_seg_test`).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

DEFAULT_DATASET = "avss4_sem_seg_test"  # without a config


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="COMBO-AVS S4 / MS3 / AVSS evaluation (PyTorch port)")
    p.add_argument("--datasets-root", default=os.environ.get(
        "DETECTRON2_DATASETS", os.environ.get("AVS_DATASETS", "AVS_dataset")))
    p.add_argument("--checkpoint", required=True, help="reference model_best.pth or .pkl")
    p.add_argument("--config-file", default="", help="a config file (default: COMBO-R50 S4)")
    p.add_argument("--dataset", default="", help="the split to score (default: the config's "
                   f"DATASETS.TEST, or {DEFAULT_DATASET} without a config)")
    p.add_argument("--max-videos", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--bf16", action="store_true", help="run the forward in bfloat16 (default: "
                   "the config's TEST.BF16, or fp32 without a config)")
    p.add_argument("--output-dir", default="")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    p.add_argument("--save-vis", action="store_true",
                   help="write coloured prediction PNGs to <out>/vis/<dataset>")
    p.add_argument("--num-devices", type=int, default=None,
                   help="ranks on this machine, one per device")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="config overrides, KEY VALUE pairs (needs --config-file)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate; returns the results of the one split scored ({"sem_seg":
    metrics}), or {split: results} when several were (rank 0's, merged,
    with --num-devices)."""
    args = parse_args(argv)
    if args.num_devices is None:
        return run(args)
    import importlib

    from combo_avs_torch.parallel import distributed

    if args.opts and not args.config_file:
        raise SystemExit(f"config overrides {args.opts} need --config-file")
    # spawned ranks find `run_rank` by its module's name, also when this file runs as __main__
    fn = importlib.import_module("combo_avs_torch.pred").run_rank
    return distributed.launch(fn, args.num_devices, (args,),
                              device_type="cpu" if _on_cpu(args) else "cuda",
                              rendezvous_dir=args.output_dir or None)


def _on_cpu(args) -> bool:
    return args.device is not None and args.device.split(":")[0] == "cpu"


def run_rank(args) -> dict:
    """One rank of `--num-devices`, on the CPU or on the CUDA device the
    launcher made current."""
    import torch

    from combo_avs_torch.parallel import distributed

    if not distributed.current().main:
        logging.getLogger("COMBO").setLevel(logging.WARNING)
    if not _on_cpu(args):
        args.device = f"cuda:{torch.cuda.current_device()}"
    return run(args)


def run(args) -> dict:
    """`main` in this process, as one rank of whatever group it joined."""
    from combo_avs_torch.parallel import distributed

    main_rank = distributed.current().main
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    from combo_avs_torch.data.catalogs import DatasetCatalog, register_all
    from combo_avs_torch.models.meta_arch import MaskFormer, build_model
    from combo_avs_torch.train.checkpoint import load_reference_checkpoint
    from combo_avs_torch.train.evaluate import eval_settings, evaluate, verify_results
    from combo_avs_torch.train.trainer import build_evaluator, build_mapper

    register_all(args.datasets_root)
    cfg = None
    if args.opts and not args.config_file:
        raise SystemExit(f"config overrides {args.opts} need --config-file")
    if args.config_file:
        from combo_avs_torch.config import setup_cfg

        cfg = setup_cfg(args.config_file, args.opts)
        model = build_model(cfg, args.device)
        settings = eval_settings(cfg, next(model.parameters()).device)
        datasets = [args.dataset] if args.dataset else list(cfg.DATASETS.TEST)
    else:
        model = MaskFormer(device=args.device)
        settings = {"size": 224, "bf16": False, "tta": None}
        datasets = [args.dataset or DEFAULT_DATASET]
    if args.bf16:
        settings["bf16"] = True
    missing = [d for d in datasets if d not in DatasetCatalog]
    if missing:
        raise SystemExit(f"{missing} not registered under {args.datasets_root} "
                         f"(found: {sorted(DatasetCatalog)})")
    load_reference_checkpoint(model, args.checkpoint)
    logging.getLogger("COMBO").info("Loaded checkpoint %s", args.checkpoint)
    vis_root = args.output_dir or (cfg.OUTPUT_DIR if cfg is not None else "")
    results = {}
    for name in datasets:
        per_split = {} if cfg is None else {"mapper": build_mapper(cfg, is_train=False),
                                            "evaluator": build_evaluator(cfg, name)}
        vis_dir = os.path.join(vis_root, "vis", name) if args.save_vis else None
        results[name], _ = evaluate(model.eval(), name, batch_size=args.batch_size,
                                    max_videos=args.max_videos, output_dir=args.output_dir,
                                    vis_dir=vis_dir, **settings, **per_split)
        if main_rank:
            print(name, results[name]["sem_seg"], flush=True)
    single = len(results) == 1
    if cfg is not None:
        # tasks key into the one split's results, or into {split: metrics}
        # (combo_avs_tpu's pred.py:84-88)
        verify_results(next(iter(results.values())) if single else
                       {name: r["sem_seg"] for name, r in results.items()},
                       cfg.TEST.get("EXPECTED_RESULTS", []))
    return next(iter(results.values())) if single else results


if __name__ == "__main__":
    main()
    sys.exit(0)
