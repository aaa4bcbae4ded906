"""The traced window: torch.profiler (host and device activity) over a
fixed number of back-to-back steps, its Chrome trace written to the
checkout's output directory, and its reduction to the numbers the
per-layer readers take.

Device operations are kernels, copies and sets. The window runs from the
start of the first traced step's span, which the harness places around
each step call (the first device operation where the host is not traced),
to the end of the last device operation. Busy time is the
union of the device operations' intervals inside it; each idle gap is
named by the innermost host operation (or host span), on any host thread,
running at its middle, or "host (between operations)" where none is.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

from h100_bench.counts import port_ops

STEP_SPAN = "h100_bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


def _short(name: str, n: int = 96) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce(trace_path: str, steps: int) -> Dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, starts = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"], cat))
        elif cat in HOST_CATS:
            if e["name"] == STEP_SPAN:
                starts.append(ts)
            host.append((ts, ts + dur, e["name"], e.get("tid")))
    if not dev:
        return {}
    t0 = min(starts) if starts else min(d[0] for d in dev)
    dev = sorted(d for d in dev if d[1] > t0)
    t1 = max(d[1] for d in dev)
    merged: List[List[float]] = []
    for s, e, _, _ in dev:
        s = max(s, t0)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_kernel, by_cat, by_op = defaultdict(float), defaultdict(float), defaultdict(float)
    kernels = 0
    for s, e, name, cat in dev:
        d = (e - max(s, t0)) * 1e-6
        by_kernel[name] += d
        if cat == "kernel":
            kernels += 1
            c = port_ops.category(name)
            by_cat[c] += d
            op = port_ops.port_op(name)
            if op:
                by_op[op] += d
    # name each idle gap by the innermost host operation open at its middle,
    # over every host thread (the backward runs on autograd's own thread)
    threads = defaultdict(list)
    for h in host:
        if h[2] != STEP_SPAN:
            threads[h[3]].append(h)
    sweeps = [[sorted(evs), 0, []] for evs in threads.values()]
    gaps = defaultdict(float)
    edges = [[t0, t0]] + merged
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        best = None
        for sw in sweeps:
            evs, i, stack = sw
            while i < len(evs) and evs[i][0] <= mid:
                while stack and stack[-1][1] < evs[i][0]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            sw[1] = i
            while stack and stack[-1][1] < mid:
                stack.pop()
            if stack and (best is None or stack[-1][1] - stack[-1][0] < best[1] - best[0]):
                best = stack[-1]
        gaps[best[2] if best else "host (between operations)"] += (b - a) * 1e-6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy * 1e-6,
        "steps": steps,
        "kernels": kernels,
        "by_category_s": dict(by_cat),
        "by_port_op_s": dict(by_op),
        "device_ops": [[f"{port_ops.category(n)}:{_short(n)}", s] for n, s in top],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda kv: -kv[1])[:10],
    }


def profile(window, host_step, steps: int, out_path: str) -> Dict:
    """`window()` (`steps` steps) under the profiler with device activity
    only (its overhead on the host is small, so the device's timeline is the
    untraced one's), then `host_step()` (one more) with host activity too,
    whose trace names the idle gaps; both traces are written to `out_path`
    and beside it.
    The window's numbers come from the first, the gaps' names from the
    second."""
    import torch
    from torch.profiler import ProfilerActivity

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    prof.export_chrome_trace(out_path)
    summary = reduce(out_path, steps)
    host_path = out_path.replace(".json", ".host.json")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(host_path)
    if summary:
        summary["idle_gaps"] = reduce(host_path, 1).get("idle_gaps", [])
    return summary
