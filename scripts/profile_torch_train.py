"""Where the time goes in the PyTorch port's S4 training step, on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py

Full-width COMBO-R50 S4 (`MaskFormer()` defaults, seeded random weights),
`make_train_step` at 8 videos x 5 frames x 224^2, K = 3 target slots, fp32
with PyTorch's default TF32 flags, the batch of `chip_smoke.py`. It prints:
  * the step's wall time (host clock around a synchronized step), median of STEPS;
  * the same step cut into forward, criterion (matcher and losses), backward
    and optimizer, with a synchronize at each cut, median of STEPS;
  * from a torch.profiler window over STEPS steps: device busy share (summed
    CUDA kernel time / window wall time), device events per step, the device
    time of the port's own kernels, and the ops with the most device time.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import TRAIN_B, train_batch  # noqa: E402
from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict, total_loss  # noqa: E402
from combo_avs_torch.models.layers import init_weights  # noqa: E402
from combo_avs_torch.models.meta_arch import MaskFormer  # noqa: E402
from combo_avs_torch.train.optim import Optimizer  # noqa: E402
from combo_avs_torch.train.train_step import (_flatten_targets, _model_inputs,  # noqa: E402
                                              make_train_step)

SIZE = 224
STEPS = 5
KERNELS = ("ms_deform_attn_fwd", "ms_deform_attn_bwd", "point_sample_fwd",
           "point_sample_dimg", "point_sample_dxy")


def phases(model, criterion, wd, opt, gen, batch) -> dict:
    """One training step (the body of make_train_step), cut into phases with
    a synchronize at each cut; returns the wall ms of each."""
    out = {}
    model.train()
    t = time.perf_counter()

    def cut(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    param = next(model.parameters())
    outputs = model(*_model_inputs(batch, param.dtype, param.device), dropout_generator=gen)
    cut("forward")
    fw = batch["gt_temporal_mask"].reshape(-1).float()
    losses = criterion(outputs, _flatten_targets(batch, param.device), frame_weight=fw,
                       generator=gen)
    loss = total_loss(losses, wd)
    cut("criterion")
    opt.zero_grad()
    loss.backward()
    cut("backward")
    opt.step()
    cut("optimizer")
    model.eval()
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}, TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}",
          flush=True)
    model = init_weights(MaskFormer(device=dev), seed=0).eval()
    criterion, wd, opt = SetCriterion(), build_weight_dict(), Optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = make_train_step(model, criterion, wd, opt, gen)
    batch = train_batch(TRAIN_B, SIZE, dev, seed=0)
    frames = TRAIN_B * batch["images"].shape[1]

    for _ in range(2):  # warm-up (cuDNN algorithm choice)
        step(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    print(f"\n== step wall ms median {med:.2f} (q1 {q1:.2f}, q3 {q3:.2f}, n={STEPS}); "
          f"{frames / med * 1e3:.1f} frames/s", flush=True)

    cuts = [phases(model, criterion, wd, opt, gen, batch) for _ in range(STEPS)]
    total = sum(float(np.median([c[k] for c in cuts])) for k in cuts[0])
    for k in cuts[0]:
        ms = float(np.median([c[k] for c in cuts]))
        print(f"{k:<10} {ms:9.2f} ms  ({ms / total:.3f} of the cut step, {total:.2f} ms)",
              flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(batch)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    # device-side events, without the ranges that annotate them (the
    # optimizer's step shows as one, spanning its kernels)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    dev_ms = sum(e.device_time for e in events if "Memcpy" not in e.name) / 1e3
    print(f"\nprofiler window {window:.1f} ms over {STEPS} steps: device kernel time "
          f"{dev_ms:.1f} ms, busy share {dev_ms / window:.3f}; per step "
          f"{len(events) / STEPS:.0f} device events; kernel time per step "
          f"{dev_ms / STEPS:.1f} ms = {dev_ms / STEPS / med:.3f} of the unprofiled step", flush=True)
    for k in KERNELS:
        hits = [e for e in events if k in e.name]
        print(f"  {k:<20} {len(hits) / STEPS:5.0f} launches/step, "
              f"{sum(e.device_time for e in hits) / 1e3 / STEPS:8.3f} ms/step", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20,
                                    max_name_column_width=60), flush=True)


if __name__ == "__main__":
    main()
