"""Where the time goes in the PyTorch port's eval step, on one NVIDIA GPU.

    python3 scripts/profile_torch_eval.py

Full-width COMBO-R50 S4 (`MaskFormer()` defaults, seeded random weights) at
4 videos x 5 frames x 224^2. For fp32 (PyTorch's default TF32 flags) and
bf16, each with the fused semantic-inference kernel (K7) at the tail and
again with the plain composition there ("plain tail"), it prints:
  * the step's wall time (host clock around a synchronized step), median of STEPS;
  * from a torch.profiler window over STEPS steps: device busy share (summed
    CUDA kernel time / window wall time), kernel launches and host-to-device
    copies per step, and the ops with the most device time;
  * the device time of every bilinear resize by call site: within the
    profiler window (and only there, so the timed steps run the plain
    `F.interpolate`), each `F.interpolate` call runs inside a profiler range
    named after the module that makes it (`resize@pixel_decoder`,
    `resize@transformer_decoder`, `resize@seminf_cuda` for the plain tail's
    upsample);
  * per top-level module (a separate run of a hooked copy): the device span
    between CUDA events recorded by forward hooks (kernel time plus any wait
    for the host), and the host time between the same hooks.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import os
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from combo_avs_torch.models.layers import init_weights  # noqa: E402
from combo_avs_torch.models.meta_arch import MaskFormer  # noqa: E402
from combo_avs_torch.ops import seminf_cuda  # noqa: E402
from combo_avs_torch.train.train_step import make_eval_step  # noqa: E402

B, T, SIZE = 4, 5, 224
STEPS = 10


def name_resizes():
    """While active, every F.interpolate call runs inside a profiler range
    named after the calling module (the port's modules look F.interpolate up
    at each call)."""
    interpolate = F.interpolate

    def named(*args, **kwargs):
        caller = sys._getframe(1).f_globals.get("__name__", "?").rsplit(".", 1)[-1]
        with record_function(f"resize@{caller}"):
            return interpolate(*args, **kwargs)

    return mock.patch.object(F, "interpolate", named)


def module_spans(model):
    """Forward hooks that record (device ms, host ms) per call of each
    top-level layer; returns the dict they fill."""
    spans = collections.defaultdict(list)
    open_ = {}
    layers = {
        "audio_backbone": [model.audio_backbone],
        "backbone": [model.backbone],
        "pre_sam_backbone": [model.pre_sam_backbone],
        "scale_factor_module": list(model.scale_factor_module),
        "pixel_decoder": [model.sem_seg_head.pixel_decoder],
        "fusion_module": [model.sem_seg_head.fusion_module],
        "audio_transformation": [model.sem_seg_head.audio_transformation],
        "predictor": [model.sem_seg_head.predictor],
    }
    for name, mods in layers.items():
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            open_[name] = (ev, time.perf_counter())

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            start, h0 = open_.pop(name)
            spans[name].append((start, ev, (time.perf_counter() - h0) * 1e3))

        for m in mods:
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)
    return spans


def timed_and_profiled(step, batch, d: str, tail: str) -> None:
    """The step's wall time over STEPS calls, then a profiler window over
    STEPS more with the resizes named by call site."""
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    print(f"\n== {d}, {tail}: step wall ms median {med:.2f} (q1 {q1:.2f}, q3 {q3:.2f}, n={STEPS}); "
          f"{B * T / med * 1e3:.1f} frames/s", flush=True)

    with name_resizes(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(batch)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    # the named ranges appear on the device too, spanning the kernels they
    # hold: left out, so that no kernel's time counts twice
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("resize@")]
    dev_ms = sum(e.device_time for e in kernels if "Memcpy" not in e.name) / 1e3
    h2d = sum(1 for e in kernels if "Memcpy HtoD" in e.name)
    print(f"profiler window {window:.1f} ms over {STEPS} steps: device kernel time "
          f"{dev_ms:.1f} ms, busy share {dev_ms / window:.3f}; per step {len(kernels) / STEPS:.0f} "
          f"device events, {h2d / STEPS:.0f} host-to-device copies", flush=True)
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=15,
                         max_name_column_width=60), flush=True)
    shown = set()  # a range is listed twice, as a host op and as a device annotation
    for e in averages:
        if (e.key.startswith("resize@") or "seminf" in e.key) and e.key not in shown:
            shown.add(e.key)
            print(f"{e.key:<40} device ms per step {e.device_time_total / 1e3 / STEPS:8.3f}, "
                  f"calls per step {e.count / STEPS:g}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_eval: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    rng = np.random.RandomState(0)
    batch = {
        "images": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
        "audio_log_mel": torch.from_numpy(rng.randn(B, T, 96, 64).astype(np.float32)).to(dev),
        "pre_masks": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
    }
    model = init_weights(MaskFormer(device=dev), seed=0).eval()
    steps = {d: make_eval_step(model, (SIZE, SIZE), bf16=d == "bf16") for d in ("fp32", "bf16")}
    probe = copy.deepcopy(model)  # the hooks go on a copy, so the timed steps run without them
    spans = module_spans(probe)
    hooked = {d: make_eval_step(probe, (SIZE, SIZE), bf16=d == "bf16") for d in ("fp32", "bf16")}

    for d, tail in [(d, t) for d in steps for t in ("K7", "plain tail")]:
        # the plain tail: semantic_inference is told that K7 takes no call
        plain = contextlib.nullcontext() if tail == "K7" else mock.patch.object(
            seminf_cuda, "kernel_takes", lambda *a: False)
        with plain:
            timed_and_profiled(steps[d], batch, d, tail)
        if tail != "K7":
            continue

        hooked[d](batch)  # warm-up of the hooked copy
        torch.cuda.synchronize()
        spans.clear()
        hooked[d](batch)
        torch.cuda.synchronize()
        print(f"{'layer':<22}{'device span ms':>15}{'host ms':>10}", flush=True)
        for name, calls in spans.items():
            dms = sum(s.elapsed_time(e) for s, e, _ in calls)
            hms = sum(h for _, _, h in calls)
            print(f"{name:<22}{dms:>15.3f}{hms:>10.3f}", flush=True)


if __name__ == "__main__":
    main()
