"""The trace reduction and the readers on a synthetic Chrome trace."""

import json

import pytest

from h100_bench import readers, spec, trace


def _trace(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STEP_SPAN, "ts": 0, "dur": 100,
           "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 10, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 40, "dur": 30, "tid": 2},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 45, "dur": 20,
           "tid": 2},
          {"ph": "X", "cat": "kernel", "name": "void ms_deform_attn_fwd_staged<float, 8>",
           "ts": 10, "dur": 20, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "nvjet_tst_128x64", "ts": 25, "dur": 10, "tid": 7},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 5, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel", "ts": 70,
           "dur": 30, "tid": 7}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.reduce(str(path), 2)


def test_reduce_unions_device_time_and_names_gaps(tmp_path):
    t = _trace(tmp_path)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(60e-6)
    assert t["kernels"] == 3
    assert t["by_port_op_s"] == {"k1_deform_fwd": pytest.approx(20e-6)}
    assert t["by_category_s"]["gemm_conv"] == pytest.approx(10e-6)
    gaps = dict(t["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert gaps["aten::nonzero"] == pytest.approx(5e-6)


def test_readers(tmp_path):
    t = _trace(tmp_path)
    ctx = {"trace": t, "calls": [("k1_deform_fwd", 0, 0, 10e-6)], "flops_per_step": 1e6,
           "peak_flops": 1e12}
    assert readers.idle_pct(ctx) == pytest.approx(40.0)
    assert readers.port_roofline_pct(ctx) == pytest.approx(50.0)
    assert readers.port_ms_per_step(ctx) == pytest.approx(0.01)
    assert readers.launches_per_step(ctx) == 1.5
    assert readers.mfu_pct(ctx) == pytest.approx(100 * 2e6 / (100e-6 * 1e12))
    assert readers.allreduce_ms_per_step(ctx) is None
    assert readers.port_roofline_pct(dict(ctx, calls=[])) is None
    for m in spec.benchmark()["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_trace_run_on_the_cpu_reports_no_device_metric(monkeypatch):
    from h100_bench import run
    from h100_bench.tests import tiny

    limits = {"loss_gap": 1.0}
    out = run.run_cell(tiny.cell("r50_s4_train", monkeypatch, limits), 99, 0.0, True, "cpu")
    assert out["metrics"] == {} and "breakdown" not in out
    assert out["attempted"] == 2 and out["correct"]
