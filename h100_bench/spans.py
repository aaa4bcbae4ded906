"""The program's spans joined with the traced window: device time and idle
time a step put down to the train step's phases, and the host syncs the
program counted.

The port records its train step's spans while a `torch.profiler` session
runs (`combo_avs_torch.utils.profiling.step_span`; `take_profiled()` hands
them over), on `time.time_ns()`, the clock of the profiler's Chrome trace
(`baseTimeNanoseconds` + `ts`). Each device operation of the window
(kernel, copy, set) is put down to the innermost span open on the host when
it was launched: its launch is the runtime or driver call with the same
correlation id, on any host thread, so the backward's launches, made by
autograd's thread while the step's thread is inside `combo.backward`, go to
the backward. Each idle gap between device operations is put down to the
innermost span open at its middle. The window and its gaps are
`trace.reduce`'s. Where the program records no spans (a program without
them) or the trace holds nothing to join, every reader returns None.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from h100_bench import spec, trace

OUT_DIR = os.path.join(spec.ROOT, "h100_bench_out")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP = "combo.step"
# phase -> the spans whose subtrees it holds
PHASES = {"forward": ("combo.forward",), "criterion": ("combo.criterion",),
          "backward": ("combo.backward",),
          "optimizer": ("combo.optim.clip", "combo.optim.update")}
# where no phase holds the time: inside a step between its phases, outside
# every span, or (device time only) a device operation with no launch found
REST = ("step", "outside", "unlaunched")


def phase_of(name: Optional[str]) -> str:
    if name is None:
        return "outside"
    for phase, roots in PHASES.items():
        if any(name == r or name.startswith(r + ".") for r in roots):
            return phase
    return "step"


def _innermost(spans: Sequence[Tuple[float, float, str, object]],
               times: Sequence[float]) -> List[Optional[str]]:
    """For each of `times` (any order), the name of the innermost span open
    then, over every thread's tree (the shortest where two threads have one
    open), or None."""
    threads = defaultdict(list)
    for s in spans:
        threads[s[3]].append(s)
    # a parent before the children that start with it
    sweeps = [[sorted(evs, key=lambda s: (s[0], -s[1])), 0, []] for evs in threads.values()]
    out: List[Optional[str]] = [None] * len(times)
    for j in sorted(range(len(times)), key=times.__getitem__):
        t, best = times[j], None
        for sw in sweeps:
            evs, i, stack = sw
            while i < len(evs) and evs[i][0] <= t:
                while stack and stack[-1][1] < evs[i][0]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            sw[1] = i
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and (best is None or stack[-1][1] - stack[-1][0] < best[1] - best[0]):
                best = stack[-1]
        out[j] = best[2] if best else None
    return out


def reduce(trace_path: str, spans: List[Dict], steps: int) -> Dict:
    """The window of the Chrome trace at `trace_path` (`steps` steps) joined
    with the program's `spans` (`Recording.spans`); {} where there is
    nothing to join. Milliseconds are a step's."""
    with open(trace_path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    dev, launches, starts = [], {}, []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in trace.DEVICE_CATS:
            dev.append((ts, ts + float(e.get("dur", 0.0)), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif e.get("name") == trace.STEP_SPAN:
            starts.append(ts)
    ended = [k for k, s in enumerate(spans) if s["end_ns"] is not None]
    if not dev or not ended:
        return {}
    # spans on the trace's clock, microseconds
    us = {k: ((spans[k]["start_ns"] - base) / 1e3, (spans[k]["end_ns"] - base) / 1e3,
              spans[k]["name"], spans[k]["thread"]) for k in ended}
    t0 = min(starts) if starts else min(d[0] for d in dev)
    dev = sorted(d for d in dev if d[1] > t0)
    t1 = max(d[1] for d in dev)
    steps_in = {k for k, (s, e, name, _) in us.items()
                if name == STEP and spans[k]["parent"] is None and s < t1 and e > t0}
    if not steps_in:
        return {}
    us = list(us.values())
    # device time by the span open at its launch
    device = dict.fromkeys((*PHASES, *REST), 0.0)
    launched = [i for i, d in enumerate(dev) if d[2] in launches]
    names = _innermost(us, [launches[dev[i][2]] for i in launched])
    for i, name in zip(launched, names):
        s, e, _ = dev[i]
        device[phase_of(name)] += e - max(s, t0)
    for s, e, corr in dev:
        if corr not in launches:
            device["unlaunched"] += e - max(s, t0)
    # idle gaps by the span open at their middle
    merged: List[List[float]] = []
    for s, e, _ in dev:
        s = max(s, t0)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [[t0, t0]] + merged
    gaps = [(a, b) for (_, a), (b, _) in zip(edges[:-1], edges[1:]) if b > a]
    idle = dict.fromkeys((*PHASES, *REST[:2]), 0.0)
    for (a, b), name in zip(gaps, _innermost(us, [0.5 * (a + b) for a, b in gaps])):
        idle[phase_of(name)] += b - a
    # host syncs counted under the spans of the window's steps
    syncs: Dict[str, int] = defaultdict(int)
    for k, sp in enumerate(spans):
        root = k
        while spans[root]["parent"] is not None:
            root = spans[root]["parent"]
        if root in steps_in:
            syncs[sp["name"]] += sp["syncs"]
    device_total, idle_total = sum(device.values()), sum(idle.values())
    return {
        "steps": steps,
        "steps_recorded": len(steps_in),
        "device_ms": {k: v * 1e-3 / steps for k, v in device.items()},
        "idle_ms": {k: v * 1e-3 / steps for k, v in idle.items()},
        "device_ms_total": device_total * 1e-3 / steps,
        "idle_ms_total": idle_total * 1e-3 / steps,
        "device_unattributed_share": sum(device[k] for k in REST) / device_total,
        "idle_unattributed_share": (idle["step"] + idle["outside"]) / idle_total
        if idle_total else 0.0,
        "launches_matched_share": len(launched) / len(dev),
        "syncs_per_step": sum(syncs.values()) / steps,
        "syncs_by_span": dict(syncs),
    }


def _window_trace() -> Optional[str]:
    """The newest window trace the harness wrote (`<cell>.trace.json`)."""
    paths = glob.glob(os.path.join(OUT_DIR, "*.trace.json"))
    return max(paths, key=os.path.getmtime) if paths else None


def _program_spans():
    try:
        from combo_avs_torch.utils import profiling
    except ImportError:
        return None
    take = getattr(profiling, "take_profiled", None)
    return take() if take else None


def joined(ctx: Dict) -> Optional[Dict]:
    """`reduce` of the traced run in `ctx`, once a run (kept in `ctx`); the
    spans and the reduction are written beside the trace
    (`<cell>.spans.json`). None where there is nothing to join."""
    if "spans" not in ctx:
        ctx["spans"] = None
        rec = _program_spans() if ctx["trace"].get("window_s") else None
        path = _window_trace() if rec is not None and rec.spans else None
        if path:
            out = reduce(path, rec.spans, ctx["trace"]["steps"]) or None
            with open(path[:-len(".trace.json")] + ".spans.json", "w") as f:
                json.dump({"recording": rec.to_json(), "window": out}, f)
            ctx["spans"] = out
    return ctx["spans"]


def _device(phase: str):
    def read(ctx: Dict) -> Optional[float]:
        j = joined(ctx)
        return j["device_ms"][phase] if j and j["launches_matched_share"] > 0 else None
    return read


def _idle(phase: str):
    def read(ctx: Dict) -> Optional[float]:
        j = joined(ctx)
        return j["idle_ms"][phase] if j else None
    return read


forward_device_ms = _device("forward")
criterion_device_ms = _device("criterion")
backward_device_ms = _device("backward")
optimizer_device_ms = _device("optimizer")
forward_idle_ms = _idle("forward")
criterion_idle_ms = _idle("criterion")
backward_idle_ms = _idle("backward")
optimizer_idle_ms = _idle("optimizer")


def host_syncs_per_step(ctx: Dict) -> Optional[float]:
    j = joined(ctx)
    return j["syncs_per_step"] if j else None
