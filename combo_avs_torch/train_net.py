"""Training command line of the PyTorch port (the repository's
`train_net.py`, ref: train_net.py:231-291).

    python -m combo_avs_torch.train_net --config-file \
        combo_avs_tpu/configs/avs_s4/COMBO_R50_bs8_90k.yaml \
        [--eval-only] [--resume] [--datasets-root DIR] [--max-iter N] [--log-every N] \
        [KEY VALUE ...]

It takes the shipped S4 and MS3 COMBO configs (R50 and PVTv2-B5). It reads
the config file in place (`config.py`, no yaml), registers the S4 and MS3
splits under the datasets root, builds the model on MODEL.DEVICE (the
current CUDA device unless the config says "cpu"; without a CUDA device it
raises), loads MODEL.WEIGHTS (R-50 or PVTv2) and the VGGish file when they
exist (a named file that is missing is logged and skipped), and trains
with periodic evaluation, `model_best.pth` and step checkpoints under
OUTPUT_DIR; `--resume` continues from the newest one. `--eval-only`
evaluates the newest checkpoint (or the initialization) on DATASETS.TEST
and checks TEST.EXPECTED_RESULTS. One process on one card: the JAX package's
`--coordinator` multi-process launch is not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="COMBO-AVS training (PyTorch port)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--datasets-root", default=os.environ.get(
        "DETECTRON2_DATASETS", os.environ.get("AVS_DATASETS", "AVS_dataset")))
    p.add_argument("--max-iter", type=int, default=None, help="override SOLVER.MAX_ITER")
    p.add_argument("--log-every", type=int, default=20, help="iterations per log line")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def setup(args):
    from combo_avs_torch.config import setup_cfg
    from combo_avs_torch.data.catalogs import register_all

    cfg = setup_cfg(args.config_file, args.opts or None)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s COMBO] %(message)s",
                        datefmt="%m/%d %H:%M:%S")
    register_all(args.datasets_root)
    return cfg


def main(argv=None):
    args = parse_args(argv)
    cfg = setup(args)

    from combo_avs_torch.train.checkpoint import load_pretrained
    from combo_avs_torch.train.evaluate import verify_results
    from combo_avs_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=args.resume or args.eval_only)
    if trainer.start_iter == 0:
        load_pretrained(trainer.model, cfg.MODEL.WEIGHTS,
                        cfg.MODEL.AUDIO.PRETRAINED_VGGISH_MODEL_PATH)
    if args.eval_only:
        results = trainer.test()
        verify_results(results, cfg.TEST.get("EXPECTED_RESULTS", []))
        print(results, flush=True)
        return results
    trainer.train(max_iter=args.max_iter, log_every=args.log_every)
    return trainer


if __name__ == "__main__":
    main()
    sys.exit(0)
