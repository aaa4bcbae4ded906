"""Profiling helpers.

Counterpart of `combo_avs_tpu/utils/profiling.py`. The reference has only
wall-clock timing around CUDA synchronizes (ref: models/evaluation/
evaluator.py:149-244). Here:

* `span(name)`: a named interval of the train step on the host's clock
  (`time.time_ns()`, the clock of the profiler's Chrome trace), recorded
  only while spans are on. Off, it is one flag check and a shared no-op
  context: nothing is allocated or recorded and no CUDA state is touched.
  `step_span(name)` opens the root of a step's tree; it also turns the
  spans on for its block while a `torch.profiler` session runs, so that a
  profiled step's device activity can be put down to its spans
  (`take_profiled()`). The tree `make_train_step` records:

      combo.step
        combo.forward
          combo.forward.audio  combo.forward.towers  combo.forward.pixel_decoder
          combo.forward.fusion  combo.forward.predictor
        combo.criterion
          combo.criterion.match_cost  combo.criterion.lsap
          combo.criterion.losses
            combo.criterion.points    (once per decoder output)
        combo.backward
        combo.optim.clip  combo.optim.update

* the host-sync counter: while a span is open, CUDA's sync debug mode warns
  on every synchronizing CUDA operation (`torch.cuda.set_sync_debug_mode`),
  and each such warning is counted under the innermost open span instead
  of being shown; the mode and the warning filters are restored when the
  outermost span closes. A sync on a thread that runs no Python (autograd's
  backward workers) raises no Python warning and is not counted. Without an
  initialized CUDA context the mode is left alone (the count stays 0 on the
  CPU);
* `recording()`: spans on for its block; yields the `Recording` that holds
  them (`Recording.dump` writes it as JSON);
* `trace(logdir)`: a context manager around `torch.profiler` that records
  the spans and writes a Chrome trace (`trace_<pid>.json`, open it in
  chrome://tracing or Perfetto) of the CPU and, when there is one, the
  CUDA device, with the spans as `combo_span` events above the operations;
* `device_timer(fn, *args)`: the best seconds per call of `fn(*args)`, timed
  between two CUDA events with one synchronize when an argument lies on a
  CUDA device, else by `time.perf_counter`;
* the greppable "s / iter per device" lines stay in `train/evaluate.py`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SYNC_WARNING = "called a synchronizing CUDA operation"
SPAN_CATEGORY = "combo_span"


class Recording:
    """The spans recorded while spans were on, in the order they opened.
    Each is a dict: `name`; `parent`, the index of the enclosing span in
    `spans` (None at a root); `thread` (the native thread id, as the
    profiler's trace gives it); `start_ns` and `end_ns` on `time.time_ns()`;
    `syncs`, the synchronizing CUDA operations counted while it was the
    innermost open span."""

    def __init__(self):
        self.spans: List[Dict] = []
        self._open: List[int] = []  # indices of the open spans, innermost last
        self._restore: Optional[Callable[[], None]] = None

    def syncs(self) -> Dict[str, int]:
        """Host syncs counted under each span name, over all its spans."""
        out: Dict[str, int] = {}
        for s in self.spans:
            out[s["name"]] = out.get(s["name"], 0) + s["syncs"]
        return out

    def to_json(self) -> Dict:
        by_name = self.syncs()
        return {"spans": self.spans, "syncs": by_name, "total_syncs": sum(by_name.values())}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    def _enter(self, name: str) -> int:
        # a root's interval holds the counter's own set-up and restore
        i = len(self.spans)
        self.spans.append({"name": name, "parent": self._open[-1] if self._open else None,
                           "thread": threading.get_native_id(), "start_ns": time.time_ns(),
                           "end_ns": None, "syncs": 0})
        if not self._open:
            self._restore = _count_syncs(self)
        self._open.append(i)
        return i

    def _exit(self, i: int) -> None:
        self._open.pop()
        if not self._open:
            self._restore()
            self._restore = None
        self.spans[i]["end_ns"] = time.time_ns()

    def _count(self) -> None:
        if self._open:
            self.spans[self._open[-1]]["syncs"] += 1


def _count_syncs(rec: Recording) -> Callable[[], None]:
    """Count each synchronizing CUDA operation into `rec` from now on;
    returns the function that restores the sync debug mode and the warning
    filters."""
    caught = warnings.catch_warnings()
    caught.__enter__()
    warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
    show = warnings.showwarning

    def count_or_show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            rec._count()
        else:
            show(message, category, filename, lineno, file, line)

    warnings.showwarning = count_or_show
    mode = None
    if torch.cuda.is_initialized():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def restore():
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)

    return restore


# Spans are on while `_ON`; they go to `_REC`. One recording at a time, on
# the thread that runs the step.
_ON = False
_REC: Optional[Recording] = None
_PROFILED = Recording()  # the steps recorded under torch.profiler sessions


class _Span:
    __slots__ = ("name", "rec", "i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _REC
        self.i = self.rec._enter(self.name)

    def __exit__(self, *exc):
        self.rec._exit(self.i)
        return False


class _ProfiledStep(_Span):
    """A root span that turns the spans on, into `_PROFILED`, for its block."""

    __slots__ = ()

    def __enter__(self):
        global _ON, _REC
        _ON, _REC = True, _PROFILED
        super().__enter__()

    def __exit__(self, *exc):
        global _ON, _REC
        try:
            return super().__exit__(*exc)
        finally:
            _ON, _REC = False, None


_NULL = contextlib.nullcontext()


def span(name: str):
    """A named interval, recorded while spans are on (module docstring)."""
    if not _ON:
        return _NULL
    return _Span(name)


def step_span(name: str):
    """`span(name)` for the root of a step's tree, which a running
    `torch.profiler` session also turns on (into `take_profiled()`)."""
    if _ON:
        return _Span(name)
    # torch's own flag, set while any torch.profiler session records
    if getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return _ProfiledStep(name)
    return _NULL


def take_profiled() -> Recording:
    """The spans of the steps recorded under `torch.profiler` sessions
    since the last call, handed over once."""
    global _PROFILED
    rec, _PROFILED = _PROFILED, Recording()
    return rec


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Spans on for the block; the yielded `Recording` holds them."""
    global _ON, _REC
    if _ON:
        raise RuntimeError("spans are already being recorded")
    rec = Recording()
    _ON, _REC = True, rec
    try:
        yield rec
    finally:
        _ON, _REC = False, None


def _span_events(rec: Recording, base_ns: int = 0) -> List[Dict]:
    """The spans as Chrome trace events (`ph` "X", category `combo_span`,
    microseconds from `base_ns`) on their own thread's track."""
    pid = os.getpid()
    return [{"ph": "X", "cat": SPAN_CATEGORY, "name": s["name"], "pid": pid,
             "tid": s["thread"], "ts": (s["start_ns"] - base_ns) / 1e3,
             "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "args": {"syncs": s["syncs"]}}
            for s in rec.spans if s["end_ns"] is not None]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with the spans on; on exit write
    `logdir/trace_<pid>.json`, the spans among its events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        with recording() as rec:
            yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        exported = json.load(f)
    exported["traceEvents"].extend(_span_events(rec, exported.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(exported, f)


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
