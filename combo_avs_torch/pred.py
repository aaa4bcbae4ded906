"""Evaluation command line for COMBO-R50 and COMBO-PVTv2-B5: a reference
checkpoint over an AVSBench S4 or MS3 split, printing the split's mIoU and
F-score.

The counterpart of the repository's `pred.py` (ref: pred.py:130-238) for
the PyTorch port. With `--config-file` the model is the one the config
describes (`models/meta_arch.py::build_model`) and frames are padded to its
INPUT.SIZE_DIVISIBILITY; without one it is `MaskFormer()`'s defaults,
COMBO-R50 S4, at 224.

    python -m combo_avs_torch.pred --datasets-root DIR --checkpoint model_best.pth \
        [--config-file combo_avs_tpu/configs/avs_ms3/COMBO_PVTV2B5_bs8_20k.yaml] \
        [--dataset avss4_sem_seg_test | avsms3_sem_seg_test | ...] [--max-videos N] \
        [--batch-size 4] [--bf16] [--output-dir DIR] [--device cpu]

It runs on the current CUDA device unless `--device` names another. Trees
to try it on: `python -m combo_avs_torch.data.synth --root DIR [--ms3-val N]`
(their splits are `avss4_sem_seg_val` and `avsms3_sem_seg_val`).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="COMBO-AVS S4 / MS3 evaluation (PyTorch port)")
    p.add_argument("--datasets-root", default=os.environ.get(
        "DETECTRON2_DATASETS", os.environ.get("AVS_DATASETS", "AVS_dataset")))
    p.add_argument("--checkpoint", required=True, help="reference model_best.pth or .pkl")
    p.add_argument("--config-file", default="", help="a config file (default: COMBO-R50 S4)")
    p.add_argument("--dataset", default="avss4_sem_seg_test")
    p.add_argument("--max-videos", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--bf16", action="store_true", help="run the forward in bfloat16")
    p.add_argument("--output-dir", default="")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    from combo_avs_torch.data.catalogs import DatasetCatalog, register_all
    from combo_avs_torch.models.meta_arch import MaskFormer, build_model
    from combo_avs_torch.train.checkpoint import load_reference_checkpoint
    from combo_avs_torch.train.evaluate import evaluate

    register_all(args.datasets_root)
    if args.dataset not in DatasetCatalog:
        raise SystemExit(f"{args.dataset} is not registered under {args.datasets_root} "
                         f"(found: {sorted(DatasetCatalog)})")
    size = 224
    if args.config_file:
        from combo_avs_torch.config import setup_cfg

        cfg = setup_cfg(args.config_file)
        model = build_model(cfg, args.device)
        if cfg.INPUT.SIZE_DIVISIBILITY > 0:
            size = cfg.INPUT.SIZE_DIVISIBILITY
    else:
        model = MaskFormer(device=args.device)
    load_reference_checkpoint(model, args.checkpoint)
    logging.getLogger("COMBO").info("Loaded checkpoint %s", args.checkpoint)
    results, _ = evaluate(model.eval(), args.dataset, batch_size=args.batch_size,
                          max_videos=args.max_videos, bf16=args.bf16, size=size,
                          output_dir=args.output_dir)
    print(args.dataset, results["sem_seg"], flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
