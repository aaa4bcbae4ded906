"""The program's spans joined with a synthetic Chrome trace
(`h100_bench/spans.py`) and the readers of the nine metrics it feeds."""

import json

import pytest

from combo_avs_torch.utils.profiling import Recording
from h100_bench import spans, spec

BASE = 1_000_000_000  # the trace's baseTimeNanoseconds
NEW = ["forward_device_ms_per_step.train", "criterion_device_ms_per_step.train",
       "backward_device_ms_per_step.train", "optimizer_device_ms_per_step.train",
       "forward_idle_ms_per_step.train", "criterion_idle_ms_per_step.train",
       "backward_idle_ms_per_step.train", "optimizer_idle_ms_per_step.train",
       "host_syncs_per_step.train"]


def _recording():
    """One step in the window on thread 1 (microseconds), and a later step
    outside it whose syncs must not count."""
    rec = Recording()
    tree = [("combo.step", None, 0, 100, 0), ("combo.forward", 0, 0, 30, 0),
            ("combo.forward.towers", 1, 5, 25, 1), ("combo.criterion", 0, 30, 50, 2),
            ("combo.backward", 0, 50, 80, 0), ("combo.optim.clip", 0, 80, 85, 0),
            ("combo.optim.update", 0, 85, 98, 0), ("combo.step", None, 1000, 1100, 5)]
    rec.spans = [{"name": n, "parent": p, "thread": 1, "start_ns": BASE + 1000 * a,
                  "end_ns": BASE + 1000 * b, "syncs": k} for n, p, a, b, k in tree]
    return rec


def _trace(tmp_path):
    ev = []
    # (correlation, launch ts, launching thread, device start, end, category)
    for corr, at, tid, s, e, cat in [
            (1, 6, 1, 10, 20, "kernel"),       # towers -> forward
            (2, 28, 1, 22, 30, "kernel"),      # forward
            (3, 35, 1, 40, 45, "kernel"),      # criterion
            (4, 55, 2, 60, 75, "kernel"),      # autograd's thread, inside the backward
            (5, 82, 1, 82, 84, "kernel"),      # clip
            (6, 90, 1, 90, 96, "kernel"),      # update
            (None, None, None, 96, 99, "gpu_memcpy"),  # no launch found
            (7, 99, 1, 100, 102, "kernel"),    # in the step, between phases
            (8, 103, 1, 104, 105, "kernel")]:  # outside every span
        ev.append({"ph": "X", "cat": cat, "name": f"k{corr}", "ts": s, "dur": e - s, "tid": 7,
                   "args": {"correlation": corr if corr else 99}})
        if corr:
            name = "cuLaunchKernel" if corr == 5 else "cudaLaunchKernel"
            ev.append({"ph": "X", "cat": "cuda_driver" if corr == 5 else "cuda_runtime",
                       "name": name, "ts": at, "dur": 1, "tid": tid,
                       "args": {"correlation": corr}})
    path = tmp_path / "cell.trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": ev}))
    return str(path)


def test_device_time_and_idle_go_to_the_spans(tmp_path):
    """Kernels go by correlation to the innermost span open at their launch
    (the backward's from another thread too); idle gaps go to the span open
    at their middle; what no phase holds is reported."""
    j = spans.reduce(_trace(tmp_path), _recording().spans, 1)
    dev, idle = j["device_ms"], j["idle_ms"]
    assert dev == pytest.approx({"forward": 0.018, "criterion": 0.005, "backward": 0.015,
                                 "optimizer": 0.008, "step": 0.002, "outside": 0.001,
                                 "unlaunched": 0.003})
    assert idle == pytest.approx({"forward": 0.002, "criterion": 0.010, "backward": 0.022,
                                  "optimizer": 0.006, "step": 0.001, "outside": 0.002})
    assert j["device_ms_total"] == pytest.approx(0.052)
    assert j["idle_ms_total"] == pytest.approx(0.043)  # the window (95 us) less busy (52)
    assert j["device_unattributed_share"] == pytest.approx(6 / 52)
    assert j["idle_unattributed_share"] == pytest.approx(3 / 43)
    assert j["launches_matched_share"] == pytest.approx(8 / 9)
    assert j["steps_recorded"] == 1
    assert j["syncs_per_step"] == 3
    assert j["syncs_by_span"] == {"combo.step": 0, "combo.forward": 0,
                                  "combo.forward.towers": 1, "combo.criterion": 2,
                                  "combo.backward": 0, "combo.optim.clip": 0,
                                  "combo.optim.update": 0}


def test_readers(tmp_path, monkeypatch):
    """The metric files read the join once a run and write the spans beside
    the trace; each returns None where the trace or the spans hold nothing."""
    path = _trace(tmp_path)
    monkeypatch.setattr(spans, "_window_trace", lambda: path)
    monkeypatch.setattr(spans, "_program_spans", _recording)
    ctx = {"trace": {"window_s": 95e-6, "steps": 1}}
    got = {m: spec.reader(m)(ctx) for m in NEW}
    assert got == pytest.approx(dict(zip(NEW, [0.018, 0.005, 0.015, 0.008, 0.002, 0.010,
                                               0.022, 0.006, 3.0])))
    written = json.loads((tmp_path / "cell.spans.json").read_text())
    assert written["recording"]["total_syncs"] == 8
    assert written["window"]["syncs_per_step"] == 3
    for empty in ({"trace": {}}, {"trace": {"window_s": 1.0, "steps": 1}}):
        monkeypatch.setattr(spans, "_program_spans", lambda: None)  # a program without spans
        assert all(spec.reader(m)(dict(empty)) is None for m in NEW)
    monkeypatch.setattr(spans, "_program_spans", _recording)
    (tmp_path / "cell.trace.json").write_text(json.dumps({"traceEvents": []}))
    assert all(spec.reader(m)({"trace": {"window_s": 1.0, "steps": 1}}) is None for m in NEW)
