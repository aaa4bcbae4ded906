"""The benchmark's data: `BENCHMARK.json`, and the configuration, workload
and per-layer metric files it names, each found by its name."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

# Seeds of the parts of a run, all derived from --seed
SEED_PARTS = {"weights": 0x0, "traffic": 0x7A11, "draws": 0x5EED, "dropout": 0xD50,
              "criterion": 0xC21, "sample": 0x5A3}


def part_seed(seed: int, part: str) -> int:
    return (seed ^ SEED_PARTS[part]) % (2 ** 63)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT, pkg: str = PKG) -> Dict:
    """The workload `name`: its BENCHMARK.json entry, its workload file
    (`workloads/<name>.json`) and its configuration file, merged as
    {"entry", "workload", "config"}."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    work = load_json(os.path.join(pkg, "workloads", f"{name}.json"))
    if work["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config {work['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    metrics = {"end_to_end": [m for m in bench["end_to_end"]
                              if name in m.get("workloads", [name])],
               "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])]}
    return {"entry": entry, "workload": work, "config": conf, "metrics": metrics}


def reader(metric: str, pkg: str = PKG) -> Callable:
    """`read(ctx)` of `metrics/<metric>.py`."""
    path = os.path.join(pkg, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"h100_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
