"""Profiling helpers.

Counterpart of `combo_avs_tpu/utils/profiling.py`. The reference has only
wall-clock timing around CUDA synchronizes (ref: models/evaluation/
evaluator.py:149-244). Here:

* `trace(logdir)`: a context manager around `torch.profiler` that writes a
  Chrome trace (`trace_<pid>.json`, open it in chrome://tracing or
  Perfetto) of the CPU and, when there is one, the CUDA device;
* `device_timer(fn, *args)`: the best seconds per call of `fn(*args)`, timed
  between two CUDA events with one synchronize when an argument lies on a
  CUDA device, else by `time.perf_counter`;
* the greppable "s / iter per device" lines stay in `train/evaluate.py`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write `logdir/trace_<pid>.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def _cuda_device(args) -> torch.device | None:
    """The device of the first CUDA tensor among `args` (lists, tuples and
    dicts searched), else None."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
        if isinstance(a, (list, tuple)):
            found = _cuda_device(a)
        elif isinstance(a, dict):
            found = _cuda_device(list(a.values()))
        else:
            continue
        if found is not None:
            return found
    return None


def device_timer(fn: Callable, *args, iters: int = 8, repeats: int = 3) -> float:
    """Best seconds per call of `fn(*args)` over `repeats` runs of `iters`
    calls each, after one warm-up call. On the card the run is timed
    between two CUDA events on the current stream, with one synchronize at
    its end; for CPU arguments by `perf_counter`."""
    device = _cuda_device(args)
    fn(*args)
    best = float("inf")
    for _ in range(repeats):
        if device is not None:
            with torch.cuda.device(device):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return best
