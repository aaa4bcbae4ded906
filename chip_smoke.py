"""Drive the PyTorch port's main path (COMBO-R50 S4 inference) once on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises, so the script exits
non-zero and never prints its last line:
  1. environment: torch/CUDA versions, the card, `nvidia-smi` name and power limit;
  2. build the deformable-attention kernel (K1) from `combo_avs_torch/csrc`;
  3. K1 against its plain PyTorch version on the card at the main-path shape
     (fp32 and bf16 value) and at a ragged shape, with CUDA-event timings;
  4. full-width COMBO-R50 S4 (`MaskFormer()` defaults) from a seeded init on
     the card, `make_eval_step` on 3 batches of 4 videos x 5 frames x 224^2 in
     fp32 and in bf16; K1 must be launched 6 times per forward;
  5. the same weights on the card (K1, TF32 off) against the CPU (plain path)
     on one 224^2 frame;
  6. a JSON line of per-kernel results, then the final JSON status line.
Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# main-path shapes: the eval batch of bench.py's default mode
B, T, SIZE = 4, 5, 224
NUM_BATCHES = 3
SEED = 0
K1_LEVELS = ((7, 7), (14, 14), (28, 28))  # res5, res4, res3 at 224^2
K1_SHAPE = dict(B=B * T, M=8, D=32, P=4)
# fp32: both sides sum the same fp32 products in another order
K1_TOL_FP32 = 1e-5  # max |kernel - plain| / max |plain|
# bf16: both sides accumulate fp32 and round the output to bf16 once, so a
# different summation order can move an element by one bf16 ulp (2^-8 relative)
K1_TOL_BF16 = 8e-3  # max |kernel - plain| / max |plain|
# card vs CPU, fp32 with TF32 off: another summation order through two R50
# towers, 6 encoder and 9 decoder layers (tests/test_e2e_parity.py's bound)
SLICE_ATOL, SLICE_RTOL = 5e-3, 1e-3
KERNEL_SOURCE = "combo_avs_torch/csrc/ms_deform_attn_fwd.cu"
KERNEL_REPLACES = "combo_avs_tpu/ops/deform_attn_pallas.py:408"


def log(*args):
    print(*args, flush=True)


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    return smi


def phase_build() -> None:
    from combo_avs_torch.ops import _build
    from combo_avs_torch.ops.deform_attn_cuda import SOURCE

    t0 = time.perf_counter()
    _build.load(SOURCE)
    dt = time.perf_counter() - t0
    log(f"[build] {SOURCE} -> {_build.library_path(SOURCE)} in {dt:.2f} s")


def k1_inputs(Bn, M, D, P, levels, Lq, dtype, device, seed):
    """Random value, locations in [-0.2, 1.2] (so some corners fall outside a
    level) with a quarter of them on exact pixel centres (integer sample
    coordinates), and softmax weights."""
    rng = np.random.RandomState(seed)
    L = len(levels)
    S = sum(h * w for h, w in levels)
    value = rng.randn(Bn, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (Bn, Lq, M, L, P, 2)).astype(np.float32)
    for l, (h, w) in enumerate(levels):
        sel = rng.rand(Bn, Lq, M, P) < 0.25
        px = (rng.randint(-1, w + 1, sel.shape) + 0.5) / w
        py = (rng.randint(-1, h + 1, sel.shape) + 0.5) / h
        loc[:, :, :, l, :, 0] = np.where(sel, px, loc[:, :, :, l, :, 0])
        loc[:, :, :, l, :, 1] = np.where(sel, py, loc[:, :, :, l, :, 1])
    logits = rng.randn(Bn, Lq, M, L * P).astype(np.float32)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).reshape(Bn, Lq, M, L, P)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(value).to(dtype), to(loc), to(w)


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    """Median over `iters` of one call each, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_k1() -> dict:
    from combo_avs_torch.ops import deform_attn_cuda as k1
    from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

    dev = torch.device("cuda", 0)
    Lq = sum(h * w for h, w in K1_LEVELS)  # encoder queries = all tokens
    result = {}
    cases = [
        ("fp32", torch.float32, K1_LEVELS, K1_SHAPE, Lq, K1_TOL_FP32),
        ("bf16", torch.bfloat16, K1_LEVELS, K1_SHAPE, Lq, K1_TOL_BF16),
        # ragged: D=16 (half a warp of lanes), Lq*M not a multiple of the block
        ("ragged_fp32", torch.float32, ((3, 5), (6, 10)), dict(B=3, M=3, D=16, P=4),
         37, K1_TOL_FP32),
        ("ragged_bf16", torch.bfloat16, ((3, 5), (6, 10)), dict(B=3, M=3, D=16, P=4),
         37, K1_TOL_BF16),
    ]
    with torch.inference_mode():
        for name, dtype, levels, shp, lq, tol in cases:
            value, loc, w = k1_inputs(shp["B"], shp["M"], shp["D"], shp["P"], levels, lq,
                                      dtype, dev, seed=len(name))
            got = k1.ms_deform_attn_cuda(value, levels, loc, w)
            want = ms_deform_attn_plain(value, levels, loc, w)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"[k1] {name}: {got.shape}/{got.dtype} vs "
                                     f"{want.shape}/{want.dtype}")
            diff = (got.float() - want.float()).abs()
            max_abs = float(diff.max())
            scale = float(want.float().abs().max())
            rel = max_abs / scale
            line = (f"[k1] {name}: out {tuple(got.shape)} max_abs_err {max_abs:.3e} "
                    f"max_rel_err {rel:.3e} (vs max|plain| {scale:.3f}; tol {tol:g})")
            if levels != K1_LEVELS:
                log(line)
            else:
                ms = cuda_time_ms(lambda: k1.ms_deform_attn_cuda(value, levels, loc, w))
                plain_ms = cuda_time_ms(lambda: ms_deform_attn_plain(value, levels, loc, w))
                log(f"{line} | K1 {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
                result[name] = dict(max_abs_err=max_abs, max_rel_err=rel, ms=ms, plain_ms=plain_ms)
            if not np.isfinite(max_abs) or rel > tol:
                raise AssertionError(f"[k1] {name}: kernel disagrees with plain: rel {rel:.3e} > {tol:g}")
    return result


def _batch(rng, dev):
    """uint8 frames and Maskige, fp32 log-mel, as the loader ships them."""
    return {
        "images": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
        "audio_log_mel": torch.from_numpy(rng.randn(B, T, 96, 64).astype(np.float32)).to(dev),
        "pre_masks": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
    }


def phase_slice(model, smi: str) -> dict:
    from combo_avs_torch.ops import deform_attn_cuda as k1
    from combo_avs_torch.train.train_step import make_eval_step

    dev = next(model.parameters()).device
    rng = np.random.RandomState(SEED)
    batches = [_batch(rng, dev) for _ in range(NUM_BATCHES)]
    steps = {name: make_eval_step(model, out_size=(SIZE, SIZE), bf16=(name == "bf16"))
             for name in ("fp32", "bf16")}
    for step in steps.values():  # warm-up (cuDNN algorithm choice), not counted
        step(batches[0])
    torch.cuda.synchronize()

    k1.launches = 0
    fps = {}
    for name, step in steps.items():
        before = k1.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = k1.launches - before
        for o in outs:
            if tuple(o.shape) != (B * T, 2, SIZE, SIZE) or o.dtype != torch.float32:
                raise AssertionError(f"[slice] {name}: output {tuple(o.shape)} {o.dtype}")
            if not bool(torch.isfinite(o).all()) or float(o.min()) < 0:
                raise AssertionError(f"[slice] {name}: output not finite and non-negative")
        if n != 6 * NUM_BATCHES:
            raise AssertionError(f"[slice] {name}: K1 launched {n} times for "
                                 f"{NUM_BATCHES} forwards, expected {6 * NUM_BATCHES}")
        fps[name] = NUM_BATCHES * B * T / dt
        log(f"[slice] {name}: {NUM_BATCHES} x [{B}x{T}x{SIZE}^2] -> {tuple(outs[0].shape)} "
            f"range [{float(outs[0].min()):.4f}, {float(outs[0].max()):.4f}], "
            f"K1 launches {n}, {fps[name]:.1f} frames/s on {smi} "
            f"(TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cuDNN {torch.backends.cudnn.allow_tf32})")
    return {"launches": k1.launches, "fps": fps}


def phase_card_vs_cpu(model) -> None:
    from combo_avs_torch.models.meta_arch import MaskFormer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED + 1)
    images = rng.randint(0, 256, (1, 1, SIZE, SIZE, 3)).astype(np.float32)
    mel = rng.randn(1, 1, 96, 64).astype(np.float32)
    pre = rng.randint(0, 256, (1, 1, SIZE, SIZE, 3)).astype(np.float32)
    cpu = MaskFormer(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    cpu.eval()
    outs = {}
    with torch.inference_mode():
        for name, m in (("cpu", cpu), ("gpu", model)):
            d = next(m.parameters()).device
            o = m(*(torch.from_numpy(a).to(d) for a in (images, mel, pre)))
            outs[name] = {k: o[k].float().cpu().numpy() for k in ("pred_logits", "pred_masks")}
    for k in ("pred_logits", "pred_masks"):
        a, b = outs["gpu"][k], outs["cpu"][k]
        log(f"[card-vs-cpu] {k} {a.shape}: max_abs_err {float(np.abs(a - b).max()):.3e} "
            f"(max|cpu| {float(np.abs(b).max()):.3f}; atol {SLICE_ATOL}, rtol {SLICE_RTOL}, TF32 off)")
        np.testing.assert_allclose(a, b, atol=SLICE_ATOL, rtol=SLICE_RTOL)


def main() -> int:
    smi = phase_env()
    phase_build()
    k1 = phase_k1()

    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import MaskFormer

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    model = MaskFormer(device=dev)
    init_weights(model, seed=SEED)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] MaskFormer() COMBO-R50 S4: {n_params} parameters, seeded init on "
        f"{torch.cuda.get_device_name(0)} in {time.perf_counter() - t0:.1f} s")
    sl = phase_slice(model, smi)
    phase_card_vs_cpu(model)

    kernels = [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sl["launches"],
        "max_abs_err": k1["fp32"]["max_abs_err"],
        "ms": k1["fp32"]["ms"],
        "plain_ms": k1["fp32"]["plain_ms"],
        "max_abs_err_bf16": k1["bf16"]["max_abs_err"],
        "ms_bf16": k1["bf16"]["ms"],
        "plain_ms_bf16": k1["bf16"]["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
