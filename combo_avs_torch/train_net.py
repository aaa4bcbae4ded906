"""Training command line of the PyTorch port (the repository's
`train_net.py`, ref: train_net.py:231-291).

    python -m combo_avs_torch.train_net --config-file \
        combo_avs_tpu/configs/avs_s4/COMBO_R50_bs8_90k.yaml \
        [--eval-only] [--resume] [--datasets-root DIR] [--max-iter N] [--log-every N] \
        [--num-devices N] [--coordinator HOST:PORT --num-processes M --process-id I] \
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
and checks TEST.EXPECTED_RESULTS.

Data parallel, one process per device (the reference's detectron2
`launch`, ref: train_net.py:284-291; the JAX package's `--num-devices` and
`--coordinator`): `--num-devices N` runs N ranks on this machine, rank i on
`cuda:i` (with `MODEL.DEVICE cpu`, N ranks on the CPU over gloo), joined
through a file under OUTPUT_DIR. Over M machines, each runs the command with
`--coordinator HOST:PORT` (machine 0's address), `--num-processes M` and its
`--process-id I`, and `--num-devices N` for its N cards (default 1); the
ranks of machine I are I*N .. I*N + N - 1. Under torchrun (RANK and
WORLD_SIZE set) each process is one rank, on `cuda:$LOCAL_RANK`. The
backend is NCCL on cards and gloo on the CPU. SOLVER.IMS_PER_BATCH is the
global batch, as in the JAX package; the ranks must divide it. Without
these flags or variables the command runs one process, as before.
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
    p.add_argument("--num-devices", type=int, default=None,
                   help="ranks on this machine, one per device")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of machine 0, for a run over several machines")
    p.add_argument("--num-processes", type=int, default=None, help="machines in the run")
    p.add_argument("--process-id", type=int, default=None, help="this machine's index")
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


def run(args):
    """Train (or with --eval-only evaluate) in this process, as one rank of
    whatever group it joined; returns the Trainer, or the results."""
    cfg = setup(args)

    from combo_avs_torch.parallel import distributed
    from combo_avs_torch.train.checkpoint import load_pretrained
    from combo_avs_torch.train.evaluate import verify_results
    from combo_avs_torch.train.trainer import Trainer

    world = distributed.current()
    if not world.main:
        logging.getLogger("COMBO").setLevel(logging.WARNING)
    trainer = Trainer(cfg, world=world)
    trainer.resume_or_load(resume=args.resume or args.eval_only)
    if trainer.start_iter == 0:
        load_pretrained(trainer.model, cfg.MODEL.WEIGHTS,
                        cfg.MODEL.AUDIO.PRETRAINED_VGGISH_MODEL_PATH)
    if args.eval_only:
        distributed.broadcast_module_(trainer.model, world)
        results = trainer.test()
        verify_results(results, cfg.TEST.get("EXPECTED_RESULTS", []))
        if world.main:
            print(results, flush=True)
        return results
    trainer.train(max_iter=args.max_iter, log_every=args.log_every)
    return trainer


def run_rank(args):
    """One spawned rank: `run`, returning only what pickles (the results)."""
    out = run(args)
    return out if args.eval_only else None


def main(argv=None):
    args = parse_args(argv)
    if args.num_devices is None and args.coordinator is None and args.num_processes is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
            from combo_avs_torch.parallel import distributed

            cfg = setup(args)
            device = "cpu" if cfg.MODEL.DEVICE == "cpu" else \
                f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            distributed.initialize(device=device)
        return run(args)

    if (args.num_processes or 1) > 1 and (args.coordinator is None or args.process_id is None):
        raise SystemExit("--num-processes above 1 needs --coordinator and --process-id")
    import importlib

    from combo_avs_torch.parallel import distributed

    cfg = setup(args)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    # spawned ranks find `run_rank` by its module's name, also when this file runs as __main__
    fn = importlib.import_module("combo_avs_torch.train_net").run_rank
    return distributed.launch(
        fn, args.num_devices or 1, (args,),
        device_type="cpu" if cfg.MODEL.DEVICE == "cpu" else "cuda",
        coordinator=args.coordinator, num_machines=args.num_processes or 1,
        machine_rank=args.process_id or 0, rendezvous_dir=cfg.OUTPUT_DIR)


if __name__ == "__main__":
    main()
    sys.exit(0)
