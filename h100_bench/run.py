"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (counted as `setup_s`): the port's
model from the configuration's shipped YAML, the benchmark's weights made
on the card from the seed and loaded under the reference key names, a pool
of batches made on the card, and the shapes warmed up: a training cell runs
its first three steps there, the ones the reference follows; an evaluation
cell runs one step. Then the window: steps enqueued back to back with no
synchronisation between them for `--seconds` seconds, a CUDA event after
each, one synchronisation at the end; the rate is the work of all the
window's steps over the time from the first step's start to the last one's
end on the card. With `--trace 1` a fixed number of steps runs under the
profiler instead and the per-layer metrics are read from its trace. Once
the window has closed and the peak memory is read, the program's state is
freed and the plain reference (`h100_bench/reference/`) decides `correct`.

Exits 2 without a card (or with fewer than the cell asks for), 3 if a
module of JAX or the JAX package got loaded; prints no result then.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from h100_bench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "combo_avs_tpu")
OUT_DIR = os.path.join(spec.ROOT, "h100_bench_out")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _env() -> None:
    """Kernel caches inside the checkout; no library loads JAX for us."""
    cache = os.path.join(spec.ROOT, ".h100_bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def timed_window(one, seconds: float, on_card: bool):
    """`one(n)` for n = 0, 1, ... enqueued back to back until `seconds` have
    passed on the host, a CUDA event after each; returns (steps, seconds
    from the first step's start to the last one's end on the card)."""
    import torch

    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t_host, steps = time.perf_counter(), 0
    while True:
        one(steps)
        steps += 1
        if on_card:
            torch.cuda.Event().record()
        if time.perf_counter() - t_host >= seconds:
            break
    if not on_card:
        return steps, time.perf_counter() - t_host
    end.record()
    torch.cuda.synchronize()
    return steps, start.elapsed_time(end) / 1e3


def traced_window(one, steps: int, on_card: bool, name: str):
    """`steps` steps under the profiler (`h100_bench.trace.profile`) and one
    more with the host traced, each inside an `h100_bench.step` span, the
    port ops' calls recorded for the first `steps`; returns (steps run,
    the trace's summary, the recorded calls)."""
    from torch.profiler import record_function

    from h100_bench import trace as tracing
    from h100_bench.counts import port_ops

    done = [0]

    def run_steps(n: int):
        for _ in range(n):
            with record_function(tracing.STEP_SPAN):
                one(done[0])
            done[0] += 1

    rec = port_ops.Recorder()

    def window():
        with rec:
            run_steps(steps)

    if not on_card:
        window()
        return done[0], {}, rec.calls
    summary = tracing.profile(window, lambda: run_steps(1), steps,
                              os.path.join(OUT_DIR, f"{name}.trace.json"))
    return done[0], summary, rec.calls


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             ref_precisions=("configured",)) -> Dict:
    """One run of `cell` (`spec.cell`); returns the result dict. `device`
    "cpu" is for the CPU tests only: no device metric is taken there.
    `ref_precisions`: the reference's precisions, the first deciding
    `correct` (the calibration reads others beside it)."""
    import torch

    from h100_bench import check, program, traffic, weights
    from h100_bench.counts import model as model_counts, peaks
    from h100_bench.reference import model as ref_model, train as ref_train

    conf, work = cell["config"], cell["workload"]
    mode, t = work["mode"], work["traffic"]
    prec = conf["precision"][mode]
    on_card = device != "cpu"
    dev = torch.device(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    conf = dict(conf, device=device)

    # ---- set-up ---------------------------------------------------------
    phases = {"start": time.perf_counter() - T0}
    model, cfg = program.build(conf, mode, dev)
    phases["build"] = time.perf_counter() - T0
    schema = weights.schema(ref_model.build(conf["model"], "meta"))
    wseed = spec.part_seed(seed, "weights")
    problems = []
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != conf["parameters"]:
        problems.append(f"the port's model has {n_params} parameters, the configuration "
                        f"{conf['parameters']}")
    model.load_state_dict(weights.make(schema, wseed, dev), strict=True)
    batches = traffic.pool(t, mode == "train", spec.part_seed(seed, "traffic"), dev)
    phases["weights_batches"] = time.perf_counter() - T0
    pool_n = len(batches)
    dseed = spec.part_seed(seed, "draws")
    checked = work["checked_steps"]
    prog_read: Dict = {}
    samples: Dict[int, object] = {}
    keep = set()
    if mode == "train":
        step, opt, crit = program.train_step(model, cfg, seed, amp=prec["amp"])
        losses = []
        for j in range(checked):
            crit.draws = traffic.draws(conf["criterion"], t, dseed, j, dev)
            metrics = step(batches[j % pool_n])
            losses.append(float(metrics["total_loss"]))
            crit.draws = None
            if j == 0:
                prog_read["grad"] = check.norms(program.first_moments(model, opt))
                prog_read["terms"] = {k: float(v) for k, v in metrics.items()
                                      if k != "total_loss"}
        initial = weights.make(schema, wseed, dev)
        prog_read["change"] = check.norms({n: p.detach() - initial[n]
                                           for n, p in model.named_parameters()
                                           if n in prog_read["grad"]})
        prog_read["losses"] = losses
        del initial

        def one(n: int):
            return step(batches[(checked + n) % pool_n])
    else:
        ev = program.eval_step(model, t["out_size"], bf16=prec["dtype"] == "bfloat16")
        rng = random.Random(spec.part_seed(seed, "sample"))
        keep = {j + pool_n * rng.randrange(work["sample_rounds"]) for j in range(pool_n)}
        ev(batches[0])  # warm-up: the one shape the cell uses

        def one(n: int):
            out = ev(batches[n % pool_n])
            if n in keep:
                samples[n] = out
            return out
    if on_card:
        torch.cuda.synchronize()
    flags = {"want": {"matmul_tf32": prec["matmul_tf32"], "cudnn_tf32": prec["cudnn_tf32"]},
             "seen": {"setup": check.tf32_flags()}}

    # ---- the window -----------------------------------------------------
    setup_s = time.perf_counter() - T0
    phases["warm"] = setup_s
    result_metrics: Dict[str, Dict] = {}
    device_info: Dict = {}
    breakdown = None
    if not trace:
        steps, window_s = timed_window(one, seconds, on_card)
    else:
        steps, summary, calls = traced_window(one, work["trace_steps"], on_card,
                                              cell["entry"]["name"])
        ctx = {"trace": summary, "calls": calls, "mode": mode,
               "flops_per_step": model_counts.step_flops(conf["model"], t, mode),
               "peak_flops": peaks.step_peak(prec)}
        for m in cell["metrics"]["per_layer"]:
            value = spec.reader(m["name"])(ctx) if summary else None
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary:
            device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    for n in sorted(keep - set(samples)):  # sampled steps past a short window's end
        one(n)
    flags["seen"]["end"] = check.tf32_flags()
    phases["window_end"] = time.perf_counter() - T0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if not trace and on_card:
        videos = steps * t["videos"]
        rates = {"train_videos_per_s": videos / window_s,
                 "eval_frames_per_s": videos * t["frames"] / window_s,
                 "peak_device_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in cell["metrics"]["end_to_end"]:
            result_metrics[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}

    # ---- the reference --------------------------------------------------
    model = step = opt = crit = ev = one = None  # noqa: F841  (the program's state goes)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, raw = {}, {}
    for how in ref_precisions:
        # "configured": the configuration's TF32 flags and compute type;
        # "float32": float32 with TF32 off
        tf32 = flags["want"] if how == "configured" else {"matmul_tf32": False,
                                                           "cudnn_tf32": False}
        dtype = torch.bfloat16 if how == "configured" and prec["dtype"] == "bfloat16" \
            else torch.float32
        with check.tf32_as(tf32):
            ref = ref_model.build(conf["model"], dev)
            initial = weights.make(schema, wseed, dev)
            ref.load_state_dict(initial, strict=True)
            if mode == "train":
                r = ref_train.train_readings(
                    ref, [batches[j % pool_n] for j in range(checked)],
                    [traffic.draws(conf["criterion"], t, dseed, j, dev) for j in range(checked)],
                    dict(conf["criterion"], **conf["model"]), conf["optimizer"],
                    spec.part_seed(seed, "dropout"), initial)
                got = check.train_numbers(prog_read, r)
                got_raw = {"program": prog_read, "reference": r}
            else:
                del initial
                ref = ref.to(dtype).eval()
                refs, progs = [], []
                with torch.no_grad():
                    for n in sorted(samples):
                        b = batches[n % pool_n]
                        o = ref(b["images"], b["audio_log_mel"], b["pre_masks"])
                        refs.append(ref_model.semantic_inference(
                            o["pred_logits"], o["pred_masks"], t["out_size"]))
                        progs.append(samples[n])
                got = check.eval_numbers(progs, refs)
                got_raw = {"frame_gaps": got.pop("frame_gaps")}
        del ref
        if not numbers:
            numbers, raw = got, got_raw
        else:
            numbers[how], raw[how] = got, got_raw
    verdict = check.judge(numbers, work["limits"], flags)
    correct = verdict["correct"] and not problems
    out = {"correct": correct, "attempted": steps, "failed": 0, "metrics": result_metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak), **device_info}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v[0], "limit": v[1]} for k, v in verdict["table"].items()}
    phases["reference_end"] = time.perf_counter() - T0
    out["_raw"] = raw
    out["_notes"] = {"problems": problems, "numbers": numbers,
                     "phases_s": {k: round(v, 3) for k, v in phases.items()}}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    cell = spec.cell(args.workload)
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100_bench: {args.workload} needs {chips} CUDA device(s), found {n}; "
              "no result without the card", file=sys.stderr)
        return 2
    try:
        import combo_avs_torch  # noqa: F401
    except ImportError as e:
        print(f"h100_bench: the program under test is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"h100_bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    notes = out.pop("_notes")
    out.pop("_raw")
    print(f"h100_bench: {power_limit()}; seed {args.seed}; notes {json.dumps(notes)}",
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
