"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 -m h100_bench.calibrate --workload <name> --seeds <n> ... \
        [--control] [--faults] [--out <file.json>]

For each seed, the compared numbers of a sound run (the harness's whole
run with a short window), against the reference in the configuration's
precision and, beside it, in float32 with TF32 off; with `--control`, of
the control put in the program's place: for a float32 training cell the
program's own bf16 AMP step (SOLVER.AMP.ENABLED); with `--faults`, of half
of each batch left out (the mean taken over the rest), planted in the
program. A step that leaves its state unchanged reads 1 on the change
number by its definition and needs no run. Each reading is printed as a
JSON line and all of them are written to `--out`.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Dict, List

from h100_bench import program, run, spec


def half_batch():
    """Patch `program` so that every training step leaves out half of its
    batch (and of the benchmark's draws), the mean taken over the rest;
    returns the undo."""
    saved = program.train_step

    def train_step(*a, **kw):
        step, opt, crit = saved(*a, **kw)

        def half_step(batch):
            draws = crit.draws
            B, T, K = batch["labels"].shape
            if draws is not None:
                n = B // 2 * T
                crit.draws = [(p[:n], c[:n * K], t[:n * K]) for p, c, t in draws]
            try:
                return step({k: v[:B // 2] for k, v in batch.items()})
            finally:
                crit.draws = draws
        return half_step, opt, crit

    program.train_step = train_step

    def undo():
        program.train_step = saved
    return undo


def reading(cell: Dict, seed: int, kind: str, seconds: float, device: str) -> Dict:
    """The numbers of one run of `kind` ("sound", "control", "half_batch")."""
    cell = copy.deepcopy(cell)
    if cell["workload"]["mode"] != "train":
        raise ValueError("the calibration reads training cells")
    cell["workload"]["limits"] = {k: float("inf") for k in cell["workload"]["limits"]}
    undo = None
    if kind == "control":
        cell["config"]["precision"]["train"]["amp"] = True
        cell["config"]["opts"] = list(cell["config"].get("opts", [])) + ["SOLVER.AMP.ENABLED",
                                                                         True]
    elif kind == "half_batch":
        undo = half_batch()
    try:
        out = run.run_cell(cell, seed, seconds, False, device=device,
                           ref_precisions=("configured", "float32"))
    finally:
        if undo:
            undo()
    return {"workload": cell["entry"]["name"], "seed": seed, "kind": kind,
            **out["_notes"]["numbers"], "raw": out["_raw"]}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    run._env()
    cell = spec.cell(args.workload)
    kinds = ["sound"] + (["control"] if args.control else [])
    if args.faults:
        kinds.append("half_batch")
    rows = []
    for seed in args.seeds:
        for kind in kinds:
            try:
                r = reading(cell, seed, kind, args.seconds, "cuda")
            except Exception as e:  # a control that crashes gives no number
                r = {"workload": args.workload, "seed": seed, "kind": kind, "error": repr(e)}
            rows.append(r)
            print(json.dumps({k: v for k, v in r.items() if k != "raw"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
