"""Guards of the harness: no JAX, no result without the card or without
the program, the data found by name, and BENCHMARK.json within the
contract's limits."""

import json
import os
import re
import shutil
import subprocess
import sys


from h100_bench import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_window_loads_no_jax():
    code = (
        "import sys, torch; torch.set_num_threads(4)\n"
        "from h100_bench import run\n"
        "from h100_bench.tests import tiny\n"
        "out = run.run_cell(tiny.cell('r50_s4_train', limits={'loss_gap': 1, 'grad_gap': 1, "
        "'change_gap': 1}), 7, 0.1, False, 'cpu')\n"
        "print('FORBIDDEN', run.forbidden_modules(), out['attempted'])\n")
    p = _run(["-c", code], ROOT, dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN [] " in p.stdout


def test_refuses_without_a_card():
    p = _run(["-m", "h100_bench.run", "--workload", "pvt_ms3_train", "--seed", "1",
              "--seconds", "1", "--trace", "0"], ROOT,
             dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout == ""
    assert "no result" in p.stderr


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["-m", "h100_bench.run", "--workload", "r50_s4_train", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    pkg = tmp_path / "h100_bench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in map(str, pkg.rglob("*")) if os.path.isfile(p)}
    conf = spec.load_json(str(pkg / "configs" / "combo_r50_s4.json"))
    conf["name"] = "combo_r50_s4_copy"
    (pkg / "configs" / "combo_r50_s4_copy.json").write_text(json.dumps(conf))
    work = spec.load_json(str(pkg / "workloads" / "r50_s4_train.json"))
    work["config"] = "combo_r50_s4_copy"
    (pkg / "workloads" / "r50_copy_train.json").write_text(json.dumps(work))
    (pkg / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return ctx['trace'].get('steps')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="combo_r50_s4_copy",
                                 file="h100_bench/configs/combo_r50_s4_copy.json"))
    bench["workloads"].append({"name": "r50_copy_train", "config": "combo_r50_s4_copy",
                               "traffic": "r50_copy_train", "chips": 1, "why": "a copy"})
    for m in bench["end_to_end"]:
        if "train_videos_per_s" == m["name"]:
            m["workloads"].append("r50_copy_train")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "whole step",
                               "moves": "train_videos_per_s", "workloads": ["r50_copy_train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("r50_copy_train", root=str(tmp_path), pkg=str(pkg))
    assert c["config"]["name"] == "combo_r50_s4_copy"
    assert [m["name"] for m in c["metrics"]["per_layer"]] == ["steps_seen.train"]
    assert {m["name"] for m in c["metrics"]["end_to_end"]} == {
        "train_videos_per_s", "peak_device_gib", "setup_s"}
    assert spec.reader("steps_seen.train", pkg=str(pkg))({"trace": {"steps": 3}}) == 3
    after = {p: open(p, "rb").read() for p in before}
    assert after == before  # nothing that was there changed


def test_benchmark_json_keeps_the_contract():
    raw = open(os.path.join(ROOT, "BENCHMARK.json")).read()
    b = json.loads(raw)
    assert len(raw.encode()) <= 64 * 1024
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["h100_bench"]
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    names = list(configs) + list(cells) + list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("h100_bench/")
        assert c["reduced"] == [] and any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(spec.PKG, "workloads", f"{w['name']}.json"))
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert all(w in cells for w in m["workloads"])
        assert all(w in e2e[m["moves"]].get("workloads", cells) for w in m["workloads"])
        assert os.path.isfile(os.path.join(spec.PKG, "metrics", f"{m['name']}.py"))
        layers.setdefault(m["name"].split(".")[0], m["layer"])
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
