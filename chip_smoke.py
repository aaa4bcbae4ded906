"""Drive the PyTorch port's paths, COMBO-R50 S4 inference, S4 training and
the S4 evaluation entry point, on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--kernels-only]

Phases, each printing what it found; any failure raises, so the script exits
non-zero and never prints its last line:
  1. environment: torch/CUDA versions, the card, `nvidia-smi` name and power limit;
  2. build every kernel from `combo_avs_torch/csrc` (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the shapes
     the two paths give it and at a ragged shape (K3/K5 also at its launch
     plan's edges), with three times for the kernel and for one PyTorch call
     computing the same function where there is one: device ms (calls
     captured back to back in a CUDA graph and replayed, so no host time
     enters), call ms (one eager call between events, the wrapper's host
     time included, as the eager main path pays it) and host us per call;
     the plain version's call ms; and the least time the card could take
     (bound):
       K1 deformable-attention forward under both launch plans (staged, the
       plan's choice, and global; fp32 and bf16 value; eval and training shapes),
       K2 its backward under both launch plans (level_slice, the plan's
       choice, and global; also a level one row over the opt-in limit),
       K3/K5 the point-sample forward, K4 its backward (the image gradient
       under both launch plans, staged, the plan's choice, and global, at
       the plan's edges),
       K7 the fused semantic inference under both launch plans (patch at
       integer ratios, the plan's choice, and pixel; fp32 and bf16 masks;
       also the time of F.interpolate alone), K6 the point gather (against
       torch.gather);
     then each kernel ranked against its library call by device ms;
  4. full-width COMBO-R50 S4 (`MaskFormer()` defaults) from a seeded init on
     the card, `make_eval_step` on 3 batches of 4 videos x 5 frames x 224^2 in
     fp32 and in bf16; K1 must be launched 6 times and K7 once per batch
     (through its patch plan);
  5. the eval entry point: a synthetic S4 val tree of 16 videos x 5 frames x
     224^2 (`data/synth.py`), the model saved as a reference `.pth` and
     loaded back, `train/evaluate.py::evaluate` at batch 4 in fp32 and bf16
     (K7 once per batch), once more in fp32 with the plain semantic
     inference on the card, whose metrics must agree, and once with the
     metrics on 2 forked worker processes (`COMBO_EVAL_PROCS=2`), whose
     metrics must be equal;
  6. `make_train_step` on the same model, 1 warm-up and 3 timed steps of
     8 videos x 5 frames x 224^2, K = 3 target slots, fp32, S4 frame weights:
     finite losses, the frozen tower and FrozenBN unchanged, the decoder
     changed, and each kernel launched as often as the step implies (K4's
     image gradient through its staged plan);
  7. the same weights on the card (TF32 off) against the CPU (plain path):
     the inference forward on one 224^2 frame, and the training losses and
     gradients on 1 video x 5 frames x 128^2 with the same injected draws;
  8. one training step at 12500 points, whose 37500 candidates the
     stratified selection does not divide, so that K6 runs once per decoder
     output;
  9. a JSON line of per-kernel results (`ms` device ms, `call_ms` call ms),
     then the final JSON status line.
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

# training shapes: the S4 recipe's batch (IMS_PER_BATCH 8) of 5-frame videos,
# K = 3 target slots (the first two valid, as bench.py's bench_train), 100
# queries, masks at 56^2, 12544 PointRend points from 3 x 12544 candidates
TRAIN_B, TRAIN_K = 8, 3
TRAIN_STEPS = 3  # timed, after one warm-up step
TRAIN_N = TRAIN_B * T  # frames
TRAIN_M = TRAIN_N * TRAIN_K  # matched masks
MASK_HW, GT_HW, NUM_POINTS, NUM_QUERIES = SIZE // 4, SIZE, 12544, 100
DEC_OUTPUTS = 10  # the final prediction and 9 aux ones
# kernel launches per training step: the 6 encoder layers once forward and
# once backward; per decoder output the matcher samples the predicted (K5
# shape) and the target masks, the criterion the 3x oversampled candidates,
# the point labels and the point logits (5 forward calls), and the backward
# takes the point logits' image gradient once; no point ever needs a gradient
TRAIN_LAUNCHES = {"k1": 6, "k2": 6, "k3": 5 * DEC_OUTPUTS, "k4_dimg": DEC_OUTPUTS, "k4_dxy": 0,
                  "k6": 0, "k7": 0}
# the K6 step: 12500 points give 37500 candidates, not a multiple of the
# stratified chunk (256), so each decoder output takes top-k and K6
FALLBACK_POINTS = 12500
# K2, K4: fp32 atomics add in a run-dependent order, K3/K5 sum four products
# in another order than the plain version: 1e-5 of max |plain|
TOL_FP32 = 1e-5
# training, card vs CPU (1 video x 5 frames x 128^2, TF32 off, the same
# weights and draws, exact top-k on both): each loss within 1e-3 relative;
# gradients by the calibrated bounds of tests/test_grad_oracle.py for two
# implementations whose activations differ by float32 noise (per leaf rel-L2
# 0.15, median over leaves 0.03, whole gradient 0.075). A few leaves have an
# exactly zero gradient (a bias followed by a GroupNorm; the fusion's query
# bias under a softmax that one shift moves alike), where both sides hold
# rounding noise: a leaf's error is taken relative to at least 1e-6 of the
# whole gradient's norm
TRAIN_VS_CPU_SIZE = 128
LOSS_RTOL_CPU, GRAD_RL2_LEAF, GRAD_RL2_MEDIAN, GRAD_RL2_ALL = 1e-3, 0.15, 0.03, 0.075
GRAD_FLOOR = 1e-6

# the point-sample forward's launch-plan edges: name, feat [N, H, W, C],
# points, inputs misaligned
POINT_EDGE_CASES = (
    ("ragged", (3, 7, 5, 33), 101, False),
    ("c3_p_odd", (3, 56, 56, 3), 12545, False),
    ("c4_staged", (3, 32, 32, 4), 1003, False),
    ("c4_global", (2, 56, 56, 4), 1000, False),
    ("one_over_stage_limit", (2, 1, 12289, 1), 3001, False),
    ("many_images", (70000, 2, 2, 1), 6, False),
    ("misaligned_c1_staged", (4, 56, 56, 1), 2048, True),
    ("misaligned_c3_global", (2, 224, 224, 3), 999, True),
    ("misaligned_channels", (2, 56, 56, 100), 300, True),
)

# K4 dimg at the criterion's shape and its launch plan's edges: name, feat
# [N, H, W, C], points, inputs misaligned, the kernel the plan must choose on
# an H100's 132 SMs (global below 8 images; and images at and one element
# over the card's opt-in shared memory, made from the card's limit in
# phase_point_sample)
DIMG_CASES = [
    ("train", (TRAIN_M, MASK_HW, MASK_HW, 1), NUM_POINTS, False, "staged"),
    ("ragged", (3, 7, 5, 33), 101, False, "global"),
    ("c4_staged", (16, 32, 32, 4), 1003, False, "staged"),
    ("c3_odd_p", (16, 56, 56, 3), 12545, False, "staged"),
    ("misaligned", (16, 56, 56, 1), 2048, True, "staged"),
    ("eight_images", (8, 56, 56, 1), 12544, False, "staged"),
    ("one_image", (1, 56, 56, 1), 12544, False, "global"),
    ("many_images", (300, 56, 56, 1), 2000, False, "staged"),
]

# K7 at the eval tail: mask [20, 100, 56, 56] -> [20, 2, 224, 224]
K7_SHAPE = dict(N=B * T, Q=NUM_QUERIES, C=2, h=MASK_HW, w=MASK_HW)
# bf16: the plain version rounds the upsampled logits and their sigmoid to
# bf16 (each at most 2^-9 relative) before its fp32 contraction, the kernel
# interpolates and takes the sigmoid in fp32 from the same bf16 inputs; the
# sum over queries of those differences stays within 8e-3 of max |plain|
K7_TOL_BF16 = 8e-3
# K6 in the criterion's fallback: M = 120 masks of 3 x 12544 candidate
# points, 9408 uncertain points each
K6_SHAPE = dict(G=TRAIN_M, NS=3 * NUM_POINTS, P=3 * NUM_POINTS // 4)
# the eval entry point: a synthetic S4 val split, evaluated at batch 4
EVAL_VIDEOS, EVAL_BATCH = 16, 4
# K7 against the plain tail on the same forward (fp32): the maps differ by
# fp32 rounding (1e-5 of max |plain|), which can flip a pixel lying within
# that of the 0.5 threshold; the metrics, rounded to 4 decimals, may move by
# a few units of the last place
EVAL_METRIC_ATOL = 1e-3

# the card's published peaks (NVIDIA H100 SXM data sheet, at the 700 W limit):
# HBM bandwidth and float32 outside the tensor cores
PEAK_BYTES_PER_S, PEAK_FP32_PER_S = 3.35e12, 67e12
# device ms: calls captured back to back in one CUDA graph, replays timed
GRAPH_CALLS, GRAPH_REPLAYS = 100, 7

REPLACES = {
    "k1": "combo_avs_tpu/ops/deform_attn_pallas.py:408",
    "k2": "combo_avs_tpu/ops/deform_attn_pallas.py:488",
    "k3": "combo_avs_tpu/ops/point_sample_pallas.py:98",
    "k5": "combo_avs_tpu/ops/point_sample_pallas.py:371",
    "k4": "combo_avs_tpu/ops/point_sample_pallas.py:112",
    "k4_dxy": "combo_avs_tpu/ops/point_sample_pallas.py:131",
    "k6": "combo_avs_tpu/ops/gather_pallas.py:49",
    "k7": "combo_avs_tpu/ops/seminf_pallas.py:67",
}


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
    from combo_avs_torch.ops import (_build, deform_attn_cuda, gather_cuda, point_sample_cuda,
                                     seminf_cuda)

    sources = [deform_attn_cuda.SOURCE, deform_attn_cuda.BWD_SOURCE, *point_sample_cuda.SOURCES,
               seminf_cuda.SOURCE, gather_cuda.SOURCE]
    t0 = time.perf_counter()
    _build.load_all(sources)
    dt = time.perf_counter() - t0
    log(f"[build] {len(sources)} sources in {dt:.2f} s: "
        + ", ".join(f"{s} -> {_build.library_path(s)}" for s in sources))


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes moved over the HBM rate or
    float32 operations over the peak rate, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def point_inputs(N, H, W, C, P, device, seed):
    """feat [N, H, W, C] and points [N, P, 2]: uniform in [-0.1, 1.1] (corners
    outside the image), a quarter on exact pixel centres."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(N, H, W, C).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (N, P, 2)).astype(np.float32)
    sel = rng.rand(N, P) < 0.25
    pts[..., 0] = np.where(sel, (rng.randint(0, W, sel.shape) + 0.5) / W, pts[..., 0])
    pts[..., 1] = np.where(sel, (rng.randint(0, H, sel.shape) + 0.5) / H, pts[..., 1])
    return torch.from_numpy(feat).to(device), torch.from_numpy(pts).to(device)


def corners_inside(x: torch.Tensor, y: torch.Tensor, H: int, W: int) -> int:
    """How many of the four bilinear corners of the pixel coordinates (x, y)
    lie inside an H x W grid: the corners a kernel reads for this data."""
    x0, y0 = torch.floor(x), torch.floor(y)
    n = 0
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            n += int(((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).sum())
    return n


def deform_corners(levels, loc: torch.Tensor) -> int:
    """In-level corners of every sampling point of locations [B, Lq, M, L, P, 2]."""
    return sum(corners_inside(loc[:, :, :, l, :, 0] * W - 0.5, loc[:, :, :, l, :, 1] * H - 0.5,
                              H, W) for l, (H, W) in enumerate(levels))


def point_corners(points: torch.Tensor, H: int, W: int) -> int:
    return corners_inside(points[..., 0] * W - 0.5, points[..., 1] * H - 0.5, H, W)


def call_time_ms(fn, iters=20, warmup=3) -> float:
    """Call ms: the median over `iters` of one eager call each, between two
    CUDA events on an idle stream, so the wrapper's host time counts too, as
    the eager main path pays it."""
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


def device_time_ms(fn) -> tuple:
    """Device ms: GRAPH_CALLS back-to-back calls captured in one CUDA graph,
    replayed between two events, over GRAPH_CALLS; the median of
    GRAPH_REPLAYS replays. No host time enters. Should the capture fail, the
    device time per call of every kernel the calls ran, from torch.profiler.
    Returns (ms, source), the source "graph" or "profiler"."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_CALLS):
                fn()
        graph.replay()
        times = []
        for _ in range(GRAPH_REPLAYS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / GRAPH_CALLS)
        del graph
        return float(np.median(times)), "graph"
    except RuntimeError as e:
        log(f"[timing] CUDA graph capture failed ({str(e).splitlines()[0]}); the device time "
            "comes from torch.profiler")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(GRAPH_CALLS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    return sum(e.device_time for e in events) / 1e3 / GRAPH_CALLS, "profiler"


def host_us(fn, calls=200) -> float:
    """Host us per call: the host clock around `calls` eager calls that
    enqueue without waiting (the stream runs behind), over `calls`."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def timings(fn, plain=None, library=None) -> dict:
    """The kernel's device ms (with its source), call ms and host us per
    call; the same for the library call computing the same function; the
    plain version's call ms (it repeats the kernel's arithmetic in many ops
    and is no yardstick of speed)."""
    t = dict(zip(("ms", "device_source"), device_time_ms(fn)), call_ms=call_time_ms(fn),
             host_us=host_us(fn))
    if plain is not None:
        t["plain_ms"] = call_time_ms(plain)
    if library is not None:
        t.update(zip(("library_ms", "library_source"), device_time_ms(library)),
                 library_call_ms=call_time_ms(library), library_host_us=host_us(library))
    return t


def describe(t: dict, library: str = "library") -> str:
    s = (f"kernel {t['ms']:.4f} ms device ({t['device_source']}), {t['call_ms']:.4f} ms call, "
         f"{t['host_us']:.1f} us host")
    if "library_ms" in t:
        s += (f"; {library} {t['library_ms']:.4f} ms device ({t['library_source']}), "
              f"{t['library_call_ms']:.4f} ms call, {t['library_host_us']:.1f} us host")
    if "plain_ms" in t:
        s += f"; plain {t['plain_ms']:.4f} ms call"
    return s


def compare(tag: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """Max abs error and max abs error over max |want|; raises above `tol`."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tag}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    max_abs = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    rel = max_abs / scale if scale > 0 else max_abs
    log(f"{tag}: {tuple(got.shape)} max_abs_err {max_abs:.3e} max_rel_err {rel:.3e} "
        f"(vs max|plain| {scale:.4g}; tol {tol:g})")
    if not np.isfinite(max_abs) or rel > tol:
        raise AssertionError(f"{tag}: kernel disagrees with plain: rel {rel:.3e} > {tol:g}")
    return {"max_abs_err": max_abs, "max_rel_err": rel}


def phase_k1(dev: torch.device) -> dict:
    """K1 against the plain version under both launch plans: the plan's own
    choice (staged where the (frame, head) value slice fits the card's
    opt-in shared memory, its query chunk made for the frame count and the
    card's SMs) through the wrapper, and the other plan forced (global: the
    plan at an opt-in limit of 0), at
    the eval shape (20 frames), the training shape (40) and a ragged shape,
    fp32 and bf16. Both plans are timed at the eval and training shapes,
    the plain version beside the chosen one."""
    from combo_avs_torch.ops import deform_attn_cuda as k1
    from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

    optin, sms = k1.smem_optin(dev.index), k1.sm_count(dev.index)
    Lq = sum(h * w for h, w in K1_LEVELS)  # encoder queries = all tokens
    train = dict(K1_SHAPE, B=TRAIN_N)
    # ragged: D=16 (half a warp of lanes), Lq*M not a multiple of the block
    ragged_levels, ragged = ((3, 5), (6, 10)), dict(B=3, M=3, D=16, P=4)
    result = {"smem_optin": optin}
    cases = [  # name, value dtype, levels, shape, queries, tolerance
        ("fp32", torch.float32, K1_LEVELS, K1_SHAPE, Lq, K1_TOL_FP32),
        ("bf16", torch.bfloat16, K1_LEVELS, K1_SHAPE, Lq, K1_TOL_BF16),
        ("train_fp32", torch.float32, K1_LEVELS, train, Lq, K1_TOL_FP32),
        ("train_bf16", torch.bfloat16, K1_LEVELS, train, Lq, K1_TOL_BF16),
        ("ragged_fp32", torch.float32, ragged_levels, ragged, 37, K1_TOL_FP32),
        ("ragged_bf16", torch.bfloat16, ragged_levels, ragged, 37, K1_TOL_BF16),
    ]
    with torch.inference_mode():
        for name, dtype, levels, shp, lq, tol in cases:
            value, loc, w = k1_inputs(shp["B"], shp["M"], shp["D"], shp["P"], levels, lq,
                                      dtype, dev, seed=len(name))
            want = ms_deform_attn_plain(value, levels, loc, w)
            plan_at = lambda limit: k1.fwd_launch_plan(  # noqa: E731
                levels, shp["B"], lq, shp["M"], shp["D"], shp["P"], value.element_size(), limit,
                sms)
            chosen = plan_at(optin)
            # a staged plan at an unbounded limit raises at launch if it does not fit
            other = plan_at(0 if chosen.kernel == "staged" else 2**31)
            row = {"chosen": chosen.kernel, "plans": {}}
            # the chosen plan runs as the wrapper picks it; the other is forced
            for plan, forced in ((chosen, None), (other, other)):
                fn = lambda: k1.ms_deform_attn_cuda(value, levels, loc, w, plan=forced)  # noqa: E731
                err = compare(f"[k1] {name} ({plan.kernel}, levels {levels})", fn(), want, tol)
                if levels != K1_LEVELS:
                    continue
                t = timings(fn, plain=(lambda: ms_deform_attn_plain(value, levels, loc, w))
                            if plan is chosen else None)
                # one FMA per in-level corner and channel
                bd = bound(nbytes(value, loc, w, want), 2 * shp["D"] * deform_corners(levels, loc))
                log(f"[k1] {name} [{shp['B']},{lq},{shp['M']},{shp['D']}]: {plan.kernel} plan "
                    f"{plan}: {describe(t)}; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({bd['bound_ms'] / t['ms']:.0%} of it)")
                row["plans"][plan.kernel] = dict(err, plan=plan._asdict(), **t, **bd)
            if levels == K1_LEVELS:
                ms = {kn: v["ms"] for kn, v in row["plans"].items()}
                log(f"[k1] {name}, device ms: " + ", ".join(f"{kn} {v:.4f}" for kn, v in ms.items())
                    + f" (chosen: {chosen.kernel}); the card's opt-in limit {optin} bytes "
                    "per block")
                result[name] = dict(row["plans"][chosen.kernel], **row)
    return result


def _one_level(rows: int) -> tuple:
    """An (H, W) level of exactly `rows` positions, as square as rows allows."""
    h = max(d for d in range(1, int(rows ** 0.5) + 1) if rows % d == 0)
    return h, rows // h


def phase_k2(dev: torch.device) -> dict:
    """K2 against autograd of the plain forward under both launch plans: the
    training shape (40 frames) through the plan's choice (level_slice) and
    forced through the global kernel (the plan at an opt-in limit of 0), a
    ragged shape, and a largest level one row more than the level-slice
    kernel's shared memory takes at the card's opt-in limit, through the
    plan's own choice (global).
    Both plans are timed at the training shape."""
    from combo_avs_torch.ops import deform_attn_cuda as k
    from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

    optin = k.smem_optin(dev.index)
    D, P = K1_SHAPE["D"], K1_SHAPE["P"]
    fits = max(r for r in range(1, optin // (8 * D) + 1)
               if k.level_slice_bytes(r, D, P) <= optin)
    over = _one_level(fits + 1)
    Lq = sum(h * w for h, w in K1_LEVELS)
    train = dict(K1_SHAPE, B=TRAIN_N)
    result = {"smem_optin": optin}
    cases = [  # name, levels, shape, queries, the opt-in limit the plan is made for, its kernel
        ("train", K1_LEVELS, train, Lq, optin, "level_slice"),
        ("train_global", K1_LEVELS, train, Lq, 0, "global"),
        ("ragged", ((3, 5), (6, 10)), dict(B=3, M=3, D=16, P=4), 37, optin, "level_slice"),
        ("over_optin", ((7, 7), over), dict(B=2, M=2, D=D, P=P), 100, optin, "global"),
    ]
    inputs = {}
    for name, levels, shp, lq, plan_optin, kernel in cases:
        plan = k.bwd_launch_plan(levels, lq, shp["M"], shp["D"], shp["P"], plan_optin)
        if plan.kernel != kernel:
            raise AssertionError(f"[k2] {name}: the launch plan chose {plan}, expected {kernel}")
        key = (levels, tuple(sorted(shp.items())), lq)
        if key not in inputs:  # train and train_global share their inputs
            value, loc, w = k1_inputs(shp["B"], shp["M"], shp["D"], shp["P"], levels, lq,
                                      torch.float32, dev, seed=10 + len(name))
            g = torch.randn((shp["B"], lq, shp["M"] * shp["D"]), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(len(name)))
            leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
            out = ms_deform_attn_plain(leaves[0], levels, leaves[1], leaves[2])
            want = torch.autograd.grad(out, leaves, g, retain_graph=True)
            inputs[key] = (value, loc, w, g, leaves, out, want)
        value, loc, w, g, leaves, out, want = inputs[key]
        # the chosen plan is passed only where it is forced, so that the
        # other cases run the wrapper's own choice
        forced = plan if plan_optin != optin else None
        fn = lambda: k.ms_deform_attn_bwd_cuda(value, levels, loc, w, g, plan=forced)  # noqa: E731
        got = fn()
        errs = [compare(f"[k2] {name} ({plan.kernel}, levels {levels}) d{n}", a, b, TOL_FP32)
                for n, a, b in zip(("value", "loc", "weights"), got, want)]
        if not name.startswith("train"):
            continue
        plain = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)  # noqa: E731
        t = timings(fn, plain=plain if name == "train" else None)
        # per in-level corner and channel: <g, v>, three FMAs into the
        # weight and the two coordinate sums, the dvalue term a*w*g and its add
        bd = bound(nbytes(value, loc, w, g, *got), 10 * shp["D"] * deform_corners(levels, loc))
        log(f"[k2] {name}: {plan.kernel} plan {plan}: {describe(t)} (autograd backward); "
            f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
            f"({bd['bound_ms'] / t['ms']:.0%} of it)")
        result[plan.kernel] = dict(max_abs_err=max(e["max_abs_err"] for e in errs),
                                   max_rel_err=max(e["max_rel_err"] for e in errs),
                                   plan=plan._asdict(), **t, **bd)
    ls, gl = result["level_slice"], result["global"]
    log(f"[k2] train, device ms: level_slice {ls['ms']:.4f} against global {gl['ms']:.4f} "
        f"({ls['ms'] / gl['ms']:.2f}x); the card's opt-in limit {optin} bytes per block")
    return result


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values in a contiguous tensor 4 bytes into its allocation."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def _grid(points: torch.Tensor) -> torch.Tensor:
    """[N, P, 2] points in [0, 1] -> F.grid_sample's [N, P, 1, 2] grid in [-1, 1]."""
    return (2.0 * points - 1.0)[:, :, None, :].contiguous()


def phase_point_sample(dev: torch.device) -> dict:
    """K3/K5 (forward) and K4 (image and point gradients) against the plain
    version and its autograd, at every training shape, with F.grid_sample
    (and its backward) as the library yardstick."""
    import torch.nn.functional as F

    from combo_avs_torch.ops import point_sample_cuda as k
    from combo_avs_torch.ops.grid_sample import point_sample_plain

    M, N, h, H, P = TRAIN_M, TRAIN_N, MASK_HW, GT_HW, NUM_POINTS
    fwd_cases = [  # name, feat [N, H, W, C], points
        ("k3_oversample", (M, h, h, 1), 3 * P),  # criterion: 3x candidates on the logits
        ("k3_point_logits", (M, h, h, 1), P),  # criterion: the differentiable logits
        ("k3_point_labels", (M, H, H, 1), P),  # criterion: the target masks
        ("k3_matcher_targets", (N, H, H, TRAIN_K), P),  # matcher: the target masks
        ("k5_matcher_preds", (N, h, h, NUM_QUERIES), P),  # matcher: 100 masks, shared points
    ]
    shapes = []
    with torch.inference_mode():
        # the launch plan's edges, checked and not timed: a ragged C > 4, odd
        # P (scalar tails), C = 3 and 4 staged and not, an image one float
        # over the staging limit, more images than grid rows, and inputs 4
        # bytes off their 16-byte alignment
        for i, (name, (n, hh, ww, c), p, misalign) in enumerate(POINT_EDGE_CASES):
            feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=50 + i)
            want = point_sample_plain(feat, pts)
            if misalign:
                feat, pts = misaligned(feat), misaligned(pts)
            compare(f"[k3/k5] {name}", k.point_sample_fwd_cuda(feat, pts), want, TOL_FP32)
        for i, (name, (n, hh, ww, c), p) in enumerate(fwd_cases):
            feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=20 + i)
            got = k.point_sample_fwd_cuda(feat, pts)
            err = compare(f"[k3/k5] {name}", got, point_sample_plain(feat, pts), TOL_FP32)
            nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
            t = timings(lambda: k.point_sample_fwd_cuda(feat, pts),
                        plain=lambda: point_sample_plain(feat, pts),
                        library=lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                                      padding_mode="zeros", align_corners=False))
            # one FMA per in-image corner and channel
            bd = bound(nbytes(feat, pts, got), 2 * c * point_corners(pts, hh, ww))
            log(f"[k3/k5] {name}: [{n},{hh},{ww},{c}] at {p} points: "
                f"{describe(t, 'F.grid_sample')}; bound {bd['bound_ms']:.4f} ms by "
                f"{bd['bound_by']} ({bd['bound_ms'] / t['ms']:.0%} of it)")
            shapes.append(dict(name=name, shape=[n, hh, ww, c], points=p, **t, **err, **bd))

    # K4 dimg under both launch plans: the plan's choice through the wrapper,
    # the other forced (global always takes a shape; staged only C <= 4 and
    # an image that fits), against the plain version's autograd
    optin, sms = k.smem_optin(dev.index), k.sm_count(dev.index)
    # images whose staged shared memory (4 bytes an element) fills the
    # card's opt-in limit exactly, and one element more
    fits = max(w for w in range(optin // 4 - 4, optin // 4 + 1)
               if k.dimg_smem_bytes(1, w, 1) <= optin)
    edges = [("at_smem_limit", (16, 1, fits, 1), 3001, False, "staged"),
             ("one_over_smem_limit", (16, 1, fits + 1, 1), 3001, False, "global")]
    dimg = {}
    for i, (name, (n, hh, ww, c), p, misalign, kernel) in enumerate(DIMG_CASES + edges):
        feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=60 + i)
        dout = torch.randn((n, p, c), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(i))
        f_ = feat.clone().requires_grad_()
        out = point_sample_plain(f_, pts)
        want = torch.autograd.grad(out, f_, dout, retain_graph=True)[0]
        if misalign:
            pts, dout = misaligned(pts), misaligned(dout)
        chosen = k.dimg_launch_plan(n, hh, ww, c, p, pts.data_ptr(), dout.data_ptr(), sms, optin)
        if chosen.kernel != kernel:
            raise AssertionError(f"[k4] dimg {name}: the launch plan chose {chosen}, "
                                 f"expected {kernel}")
        plans = [(chosen, None)]
        if chosen.kernel == "staged":  # global at an opt-in limit of 0
            other = k.dimg_launch_plan(n, hh, ww, c, p, 0, 0, sms, 0)
            plans.append((other, other))
        else:  # staged where it can take the shape: the plan for a card of one SM
            other = k.dimg_launch_plan(n, hh, ww, c, p, pts.data_ptr(), dout.data_ptr(), 1, optin)
            if other.kernel == "staged":
                plans.append((other, other))
        for plan, forced in plans:
            fn = lambda: k.point_sample_dimg_cuda(pts, dout, (hh, ww), plan=forced)  # noqa: E731
            err = compare(f"[k4] dimg {name} ({plan.kernel}, [{n},{hh},{ww},{c}] at {p} "
                          f"points{', misaligned' if misalign else ''})", fn(), want, TOL_FP32)
            if name != "train":
                continue
            got = fn()
            nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
            dlib = dout.permute(0, 2, 1)[..., None].contiguous()  # [N, C, P, 1]
            # the library's backward as autograd calls it for the image: one
            # ATen op (bilinear, zero padding, align_corners=False)
            lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
                dlib, nchw, grid, 0, 0, False, [True, False])
            plain = lambda: torch.autograd.grad(out, f_, dout, retain_graph=True)  # noqa: E731
            t = timings(fn, plain=plain if forced is None else None,
                        library=lib if forced is None else None)
            # a product and an add per in-image corner and channel
            bd = bound(nbytes(pts, dout, got), 2 * c * point_corners(pts, hh, ww))
            log(f"[k4] dimg {name}: {plan.kernel} plan {plan}: "
                f"{describe(t, 'grid_sampler_2d_backward')}; bound {bd['bound_ms']:.4f} ms by "
                f"{bd['bound_by']} ({bd['bound_ms'] / t['ms']:.0%} of it)")
            dimg[plan.kernel] = dict(err, plan=plan._asdict(), **t, **bd)
    # an inf among one image's gradients, through the staged plan: inf at
    # the point's four corners, as the plain version has it
    feat, pts = point_inputs(16, MASK_HW, MASK_HW, 1, 2048, dev, seed=70)
    pts[1, 7] = torch.tensor([10.3 / MASK_HW, 20.3 / MASK_HW], device=dev)  # 4 corners inside
    dout = torch.randn((16, 2048, 1), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(70))
    dout[1, 7, 0] = float("inf")
    if k.dimg_launch_plan(16, MASK_HW, MASK_HW, 1, 2048, pts.data_ptr(), dout.data_ptr(), sms,
                          optin).kernel != "staged":
        raise AssertionError("[k4] dimg inf_gradient: the launch plan did not stage it")
    f_ = feat.clone().requires_grad_()
    want = torch.autograd.grad(point_sample_plain(f_, pts), f_, dout)[0]
    got = k.point_sample_dimg_cuda(pts, dout, (MASK_HW, MASK_HW))
    finite = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), finite) or int((~finite).sum()) != 4:
        raise AssertionError("[k4] dimg with an inf gradient: the non-finite elements differ "
                             "from the plain version's")
    compare("[k4] dimg inf_gradient (finite elements)", got[finite], want[finite], TOL_FP32)

    st, gl = dimg["staged"], dimg["global"]
    log(f"[k4] dimg train, device ms: staged {st['ms']:.4f} against global {gl['ms']:.4f} "
        f"({st['ms'] / gl['ms']:.2f}x) and grid_sampler_2d_backward {st['library_ms']:.4f}; "
        f"the card's opt-in limit {optin} bytes per block, {sms} SMs")

    back = {}
    for name, (n, hh, ww, c), p in [("train", (M, h, h, 1), P), ("ragged", (3, 7, 5, 33), 101)]:
        feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=40 + len(name))
        dout = torch.randn((n, p, c), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(len(name)))
        f_, p_ = feat.clone().requires_grad_(), pts.clone().requires_grad_()
        out = point_sample_plain(f_, p_)
        want_dp = torch.autograd.grad(out, p_, dout, retain_graph=True)[0]
        got_dp = k.point_sample_dxy_cuda(feat, pts, dout)
        e_xy = compare(f"[k4] {name} dxy", got_dp, want_dp, TOL_FP32)
        if name != "train":
            continue
        nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
        dlib = dout.permute(0, 2, 1)[..., None].contiguous()  # [N, C, P, 1]
        t = timings(lambda: k.point_sample_dxy_cuda(feat, pts, dout),
                    plain=lambda: torch.autograd.grad(out, p_, dout, retain_graph=True),
                    library=lambda: torch.ops.aten.grid_sampler_2d_backward(
                        dlib, nchw, grid, 0, 0, False, [False, True]))
        # per point and channel: two corner differences, two weights, a sum
        # and an FMA with dout, for x and for y
        bd = bound(nbytes(feat, pts, dout, got_dp), 14 * c * n * p)
        log(f"[k4] dxy: [{n},{hh},{ww},{c}] at {p} points: "
            f"{describe(t, 'grid_sampler_2d_backward')} (autograd); bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}")
        back["dxy"] = dict(e_xy, **t, **bd)
        del out
    return {"fwd": shapes, "dimg": dict(st, global_plan=gl), **back}


def seminf_inputs(N, Q, C, h, w, dtype, device, seed):
    """cls_sm [N, Q, C] (softmax over C + 1 classes, the last dropped), mask
    logits [N, Q, h, w] of spread 4 in `dtype`, and a 0/1 temporal mask [N]
    with most frames on."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, Q, C + 1)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    cls = (e / e.sum(-1, keepdims=True))[..., :C].astype(np.float32)
    mask = (rng.randn(N, Q, h, w) * 4).astype(np.float32)
    tm = (rng.rand(N) > 0.2).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(cls), to(mask).to(dtype), to(tm)


def phase_k7(dev: torch.device) -> dict:
    """K7 against the plain composition under both launch plans: the plan's
    choice through the wrapper and the pixel kernel forced (the patch kernel
    takes integer ratios of at least 2 only), at the eval tail's shape (fp32
    and bf16 masks), integer ratios other than 4, a ratio of 1 and a ragged
    one, each with the temporal mask on and off; both plans timed at the eval shape, with the
    time of the resize alone."""
    import torch.nn.functional as F

    from combo_avs_torch.ops import seminf_cuda as k

    result = {}
    x3 = dict(K7_SHAPE, N=4)  # 56^2 -> 168^2: ratio 3
    cases = [("fp32", torch.float32, K7_SHAPE, (SIZE, SIZE), TOL_FP32),
             ("bf16", torch.bfloat16, K7_SHAPE, (SIZE, SIZE), K7_TOL_BF16),
             ("x3_fp32", torch.float32, x3, (3 * MASK_HW, 3 * MASK_HW), TOL_FP32),
             ("x3_bf16", torch.bfloat16, x3, (3 * MASK_HW, 3 * MASK_HW), K7_TOL_BF16),
             ("x2x8_c5_fp32", torch.float32, dict(N=3, Q=9, C=5, h=7, w=6), (14, 48), TOL_FP32),
             ("ragged_fp32", torch.float32, dict(N=3, Q=7, C=5, h=5, w=9), (13, 31), TOL_FP32),
             ("same_size_fp32", torch.float32, dict(N=2, Q=3, C=8, h=6, w=6), (6, 6), TOL_FP32)]
    with torch.inference_mode():
        for name, dtype, shp, size, tol in cases:
            cls, mask, tm = seminf_inputs(shp["N"], shp["Q"], shp["C"], shp["h"], shp["w"],
                                          dtype, dev, seed=30 + len(name))
            chosen = k.launch_plan(shp["N"], shp["Q"], shp["C"], shp["h"], shp["w"], *size)
            integer = (size[0] % shp["h"] == 0 and size[1] % shp["w"] == 0
                       and min(size[0] // shp["h"], size[1] // shp["w"]) >= 2)
            if chosen.kernel != ("patch" if integer else "pixel"):
                raise AssertionError(f"[k7] {name}: the launch plan chose {chosen}")
            plans = [(chosen, None)]
            if chosen.kernel == "patch":
                pixel = k.pixel_plan(shp["Q"], shp["C"], *size)
                plans.append((pixel, pixel))
            row = {"chosen": chosen.kernel, "plans": {}}
            for plan, forced in plans:
                for temporal in (None, tm):
                    got = k.seminf_cuda(cls, mask, size, temporal, plan=forced)
                    err = compare(f"[k7] {name} ({plan.kernel}"
                                  f"{'' if temporal is None else ', temporal'})", got,
                                  k.semantic_inference_plain(cls, mask, size, temporal), tol)
                if name not in ("fp32", "bf16"):
                    continue
                t = timings(lambda: k.seminf_cuda(cls, mask, size, plan=forced),
                            plain=(lambda: k.semantic_inference_plain(cls, mask, size))
                            if forced is None else None)
                # per (pixel, query): the bilinear sample (4 products, 3 sums
                # and the weights' share), the sigmoid (negate, exp, add,
                # reciprocal) and a multiply-add per class
                flops = shp["N"] * size[0] * size[1] * shp["Q"] * (12 + 2 * shp["C"])
                bd = bound(nbytes(cls, mask) + shp["N"] * shp["C"] * size[0] * size[1] * 4,
                           flops)
                log(f"[k7] {name}: mask {list(mask.shape)} -> {size}: {plan.kernel} plan "
                    f"{plan}: {describe(t)}; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({bd['bound_ms'] / t['ms']:.0%} of it)")
                row["plans"][plan.kernel] = dict(err, plan=plan._asdict(), **t, **bd)
            if name not in ("fp32", "bf16"):
                continue
            # F.interpolate alone: a part of the plain version, not the same function
            resize = timings(lambda: F.interpolate(mask, size=size, mode="bilinear",
                                                   align_corners=False, antialias=False))
            pa, px = row["plans"]["patch"], row["plans"]["pixel"]
            log(f"[k7] {name}, device ms: patch {pa['ms']:.4f} against pixel {px['ms']:.4f} "
                f"({pa['ms'] / px['ms']:.2f}x); F.interpolate alone {resize['ms']:.4f} ms device "
                f"({resize['device_source']}), {resize['call_ms']:.4f} ms call, "
                f"{resize['host_us']:.1f} us host")
            result[name] = dict(pa, pixel_plan=px, resize_ms=resize["ms"],
                                resize_call_ms=resize["call_ms"])
    return result


def phase_k6(dev: torch.device) -> dict:
    """K6 against torch.gather, exactly, at the criterion fallback's shape
    (indices from a top-k, as there) and at a ragged one."""
    from combo_avs_torch.ops import gather_cuda as k

    result = {}
    for name, (G, NS, P) in (("train", tuple(K6_SHAPE.values())), ("ragged", (3, 1500, 1001))):
        g = torch.Generator(device=dev).manual_seed(G)
        src = torch.rand((G, NS, 2), generator=g, device=dev)
        idx = torch.topk(torch.randn((G, NS), generator=g, device=dev), P, dim=-1).indices
        idx[:, 0], idx[:, -1] = 0, NS - 1  # the edge indices
        got = k.gather_points_cuda(src, idx)
        want = k.gather_points_plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[k6] {name}: differs from torch.gather")
        log(f"[k6] {name}: [{G}, {NS}, 2] -> {P}: equal to torch.gather")
        if name != "train":
            continue
        idx2 = idx[..., None].expand(-1, -1, 2)
        t = timings(lambda: k.gather_points_cuda(src, idx),
                    plain=lambda: k.gather_points_plain(src, idx),
                    library=lambda: torch.gather(src, 1, idx2))
        # the index and the output once, and each source point this data
        # reads (a top-k selects distinct points of its row)
        touched = int(torch.unique(idx + torch.arange(G, device=dev)[:, None] * NS).numel())
        bd = bound(nbytes(idx, got) + 8 * touched, 0)
        log(f"[k6] {name}: {describe(t, 'torch.gather')}; bound {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']}")
        result = dict(max_abs_err=0.0, **t, **bd)
    return result


def _batch(rng, dev):
    """uint8 frames and Maskige, fp32 log-mel, as the loader ships them."""
    return {
        "images": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
        "audio_log_mel": torch.from_numpy(rng.randn(B, T, 96, 64).astype(np.float32)).to(dev),
        "pre_masks": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
    }


def train_batch(b, size, dev, seed):
    """A loader-format S4 training batch made on `dev`: uint8 frames and
    Maskiges, fp32 log-mel, K = 3 slots (the first two valid) of int labels
    and bool masks, the first frame of each video weighted."""
    g = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.zeros((b, T, TRAIN_K), dtype=torch.bool, device=dev)
    valid[..., :2] = True
    frame_weight = torch.zeros((b, T), device=dev)
    frame_weight[:, 0] = 1.0
    return {
        "images": torch.randint(0, 256, (b, T, size, size, 3), generator=g, device=dev,
                                dtype=torch.uint8),
        "audio_log_mel": torch.randn((b, T, 96, 64), generator=g, device=dev),
        "pre_masks": torch.randint(0, 256, (b, T, size, size, 3), generator=g, device=dev,
                                   dtype=torch.uint8),
        "labels": torch.randint(0, 2, (b, T, TRAIN_K), generator=g, device=dev),
        "masks": torch.rand((b, T, TRAIN_K, size, size), generator=g, device=dev) > 0.5,
        "valid": valid,
        "gt_temporal_mask": frame_weight,
    }


def reset_counts():
    from combo_avs_torch.ops import deform_attn_cuda, gather_cuda, point_sample_cuda, seminf_cuda

    deform_attn_cuda.launches = deform_attn_cuda.bwd_launches = 0
    deform_attn_cuda.fwd_plan_launches.update(dict.fromkeys(deform_attn_cuda.fwd_plan_launches, 0))
    point_sample_cuda.fwd_launches = point_sample_cuda.dimg_launches = 0
    point_sample_cuda.dxy_launches = 0
    point_sample_cuda.dimg_plan_launches.update(dict.fromkeys(point_sample_cuda.dimg_plan_launches,
                                                              0))
    gather_cuda.launches = seminf_cuda.launches = 0
    seminf_cuda.plan_launches.update(dict.fromkeys(seminf_cuda.plan_launches, 0))


def read_counts() -> dict:
    from combo_avs_torch.ops import deform_attn_cuda, gather_cuda, point_sample_cuda, seminf_cuda

    return {"k1": deform_attn_cuda.launches, "k2": deform_attn_cuda.bwd_launches,
            "k3": point_sample_cuda.fwd_launches, "k4_dimg": point_sample_cuda.dimg_launches,
            "k4_dxy": point_sample_cuda.dxy_launches, "k6": gather_cuda.launches,
            "k7": seminf_cuda.launches}


def phase_slice(model, smi: str) -> dict:
    from combo_avs_torch.ops import deform_attn_cuda, seminf_cuda
    from combo_avs_torch.train.train_step import make_eval_step

    dev = next(model.parameters()).device
    Lq = sum(h * w for h, w in K1_LEVELS)
    optin = deform_attn_cuda.smem_optin(dev.index)
    rng = np.random.RandomState(SEED)
    batches = [_batch(rng, dev) for _ in range(NUM_BATCHES)]
    steps = {name: make_eval_step(model, out_size=(SIZE, SIZE), bf16=(name == "bf16"))
             for name in ("fp32", "bf16")}
    for step in steps.values():  # warm-up (cuDNN algorithm choice), not counted
        step(batches[0])
    torch.cuda.synchronize()

    reset_counts()
    fps, k1_plans, k7_plans = {}, {}, {}
    for name, step in steps.items():
        before = read_counts()
        plans_before = dict(deform_attn_cuda.fwd_plan_launches)
        k7_before = dict(seminf_cuda.plan_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counts()
        n = after["k1"] - before["k1"]
        k1_plans[name] = {kn: c - plans_before[kn]
                          for kn, c in deform_attn_cuda.fwd_plan_launches.items()}
        # every K1 launch of the slice takes the plan fwd_launch_plan picks for its shape
        chosen = deform_attn_cuda.fwd_launch_plan(
            K1_LEVELS, B * T, Lq, K1_SHAPE["M"], K1_SHAPE["D"], K1_SHAPE["P"],
            2 if name == "bf16" else 4, optin, deform_attn_cuda.sm_count(dev.index)).kernel
        if k1_plans[name][chosen] != n:
            raise AssertionError(f"[slice] {name}: K1 launches by plan {k1_plans[name]}, "
                                 f"expected all {n} through {chosen}")
        # the eval tail's 4x upsample takes K7's patch plan
        k7_plans[name] = {kn: c - k7_before[kn] for kn, c in seminf_cuda.plan_launches.items()}
        if k7_plans[name] != {"pixel": 0, "patch": NUM_BATCHES}:
            raise AssertionError(f"[slice] {name}: K7 launches by plan {k7_plans[name]}, "
                                 f"expected all {NUM_BATCHES} through patch")
        for o in outs:
            if tuple(o.shape) != (B * T, 2, SIZE, SIZE) or o.dtype != torch.float32:
                raise AssertionError(f"[slice] {name}: output {tuple(o.shape)} {o.dtype}")
            if not bool(torch.isfinite(o).all()) or float(o.min()) < 0:
                raise AssertionError(f"[slice] {name}: output not finite and non-negative")
        want = {k: before[k] + {"k1": 6, "k7": 1}.get(k, 0) * NUM_BATCHES for k in before}
        if after != want:
            raise AssertionError(f"[slice] {name}: launches {after} (before {before}) for "
                                 f"{NUM_BATCHES} forwards, expected {want}: K1 6 and K7 1 "
                                 "per forward")
        fps[name] = NUM_BATCHES * B * T / dt
        log(f"[slice] {name}: {NUM_BATCHES} x [{B}x{T}x{SIZE}^2] -> {tuple(outs[0].shape)} "
            f"range [{float(outs[0].min()):.4f}, {float(outs[0].max()):.4f}], "
            f"K1 launches {n} (by plan {k1_plans[name]}), K7 {after['k7'] - before['k7']} "
            f"(by plan {k7_plans[name]}), "
            f"{fps[name]:.1f} frames/s on {smi} "
            f"(TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cuDNN {torch.backends.cudnn.allow_tf32})")
    return {"launches": read_counts(), "fps": fps, "k1_plans": k1_plans, "k7_plans": k7_plans}


def phase_eval_entry(model, smi: str) -> dict:
    """The S4 evaluation entry point at full width: a synthetic val tree,
    the model through a reference `.pth` and back, `evaluate` at batch 4 in
    fp32 and bf16 (K7 once per batch, K1 six times), then fp32 again with the
    plain semantic inference on the card, whose metrics must agree, and fp32
    with the metrics on COMBO_EVAL_PROCS=2 worker processes forked from this
    process (which holds a CUDA context), whose metrics must be equal."""
    import contextlib
    import os
    import tempfile
    from unittest import mock

    from combo_avs_torch.data.catalogs import register_all
    from combo_avs_torch.data.synth import make_s4
    from combo_avs_torch.models.meta_arch import MaskFormer
    from combo_avs_torch.ops import seminf_cuda
    from combo_avs_torch.train.checkpoint import (load_reference_checkpoint,
                                                  save_reference_checkpoint)
    from combo_avs_torch.train.evaluate import evaluate

    batches = -(-EVAL_VIDEOS // EVAL_BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_s4(tmp, 0, EVAL_VIDEOS, size=SIZE)
        register_all(tmp)
        path = f"{tmp}/model_best.pth"
        save_reference_checkpoint(model, path)
        loaded = MaskFormer()  # on the current CUDA device
        load_reference_checkpoint(loaded, path)
        for k, v in model.state_dict().items():
            if not torch.equal(loaded.state_dict()[k], v):
                raise AssertionError(f"[eval-entry] {k} changed through the .pth")
        loaded.eval()
        log(f"[eval-entry] {EVAL_VIDEOS} synthetic S4 val videos x {T} frames x {SIZE}^2 and "
            f"the .pth round trip in {time.perf_counter() - t0:.1f} s")
        runs = (("fp32", False, True, 0), ("bf16", True, True, 0),
                ("fp32_plain_tail", False, False, 0), ("fp32_procs2", False, True, 2))
        for name, bf16, fused, procs in runs:
            # the plain tail: semantic_inference is told the kernel takes no call
            tail = contextlib.nullcontext() if fused else mock.patch.object(
                seminf_cuda, "kernel_takes", lambda *a: False)
            env = mock.patch.dict(os.environ, {"COMBO_EVAL_PROCS": str(procs)})
            with tail, env:
                torch.cuda.synchronize()
                reset_counts()
                res, tm = evaluate(loaded, "avss4_sem_seg_val", batch_size=EVAL_BATCH, bf16=bf16,
                                   size=SIZE)
                counts = read_counts()
            want = {k: {"k1": 6 * batches, "k7": batches if fused else 0}.get(k, 0)
                    for k in counts}
            if counts != want:
                raise AssertionError(f"[eval-entry] {name}: launches {counts}, expected {want}")
            m = res["sem_seg"]
            if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
                raise AssertionError(f"[eval-entry] {name}: metrics out of range: {m}")
            log(f"[eval-entry] {name}: mIoU {m['mIoU']:.4f}, f_score {m['f_score']:.4f}; "
                f"{tm['videos']} videos, {tm['frames']} frames in {tm['total_s']:.3f} s "
                f"(data {tm['data_s']:.3f}, compute {tm['compute_s']:.3f}, eval "
                f"{tm['eval_s']:.3f}): {tm['videos'] / tm['total_s']:.2f} videos/s, "
                f"{tm['frames'] / tm['total_s']:.1f} frames/s; launches {counts} on {smi}")
            out[name] = dict(metrics=m, timing=tm, launches=counts)
    a, b = out["fp32"]["metrics"], out["fp32_plain_tail"]["metrics"]
    if any(abs(a[k] - b[k]) > EVAL_METRIC_ATOL for k in a):
        raise AssertionError(f"[eval-entry] K7 {a} and the plain tail {b} disagree beyond "
                             f"{EVAL_METRIC_ATOL}")
    log(f"[eval-entry] K7 against the plain tail, fp32: {a} vs {b} (atol {EVAL_METRIC_ATOL})")
    if out["fp32_procs2"]["metrics"] != a:
        raise AssertionError(f"[eval-entry] metrics on 2 worker processes "
                             f"{out['fp32_procs2']['metrics']} differ from inline {a}")
    log(f"[eval-entry] metrics on 2 forked worker processes equal the inline ones")
    return out


def phase_train_fallback(model) -> dict:
    """One full-width training step at FALLBACK_POINTS points: the
    criterion's uncertain-point selection takes top-k and K6 once per decoder
    output; the losses must be finite."""
    from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict
    from combo_avs_torch.losses.matcher import HungarianMatcher
    from combo_avs_torch.train.optim import Optimizer
    from combo_avs_torch.train.train_step import make_train_step

    dev = next(model.parameters()).device
    crit = SetCriterion(matcher=HungarianMatcher(num_points=FALLBACK_POINTS),
                        num_points=FALLBACK_POINTS)
    step = make_train_step(model, crit, build_weight_dict(), Optimizer(model),
                           torch.Generator(device=dev).manual_seed(SEED + 4))
    batch = train_batch(TRAIN_B, SIZE, dev, seed=SEED + 4)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    m = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    if counts["k6"] != DEC_OUTPUTS or not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"[train-k6] launches {counts} (K6 expected {DEC_OUTPUTS}), "
                             f"total_loss {m['total_loss']}")
    log(f"[train-k6] one step of [{TRAIN_B}x{T}x{SIZE}^2] at {FALLBACK_POINTS} points: "
        f"{dt:.3f} s, total_loss {m['total_loss']:.6f}, launches {counts}")
    return {"launches": counts, "total_loss": m["total_loss"], "s": dt}


def phase_train(model, smi: str) -> dict:
    """make_train_step at full width: 1 warm-up and TRAIN_STEPS timed steps."""
    from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict
    from combo_avs_torch.ops import point_sample_cuda
    from combo_avs_torch.train.optim import Optimizer
    from combo_avs_torch.train.train_step import make_train_step

    dev = next(model.parameters()).device
    wd = build_weight_dict()
    step = make_train_step(model, SetCriterion(), wd, Optimizer(model),
                           torch.Generator(device=dev).manual_seed(SEED))
    batch = train_batch(TRAIN_B, SIZE, dev, seed=SEED)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for i in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        log(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: {times[-1]:.4f} s, "
            f"total_loss {metrics[-1]['total_loss']:.6f}, loss_ce {metrics[-1]['loss_ce']:.6f}, "
            f"loss_mask {metrics[-1]['loss_mask']:.6f}, loss_dice {metrics[-1]['loss_dice']:.6f}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + TRAIN_STEPS
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"[train] launches {counts} in {steps} steps, expected {want}")
    dimg_plans = dict(point_sample_cuda.dimg_plan_launches)
    if dimg_plans != {"global": 0, "staged": want["k4_dimg"]}:
        raise AssertionError(f"[train] K4 dimg launches by plan {dimg_plans}: every one should "
                             "take the staged plan")
    for m in metrics:
        if set(m) != {"total_loss", *wd} or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"[train] losses not finite or misnamed: {m}")
    after = model.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    buffers = {n for n, _ in model.named_buffers()}
    frozen = {k for k in before if k.startswith("audio_backbone.")} | buffers
    decoder = {k for k in before if k.startswith("sem_seg_head.predictor.")}
    if changed & frozen:
        raise AssertionError(f"[train] frozen tensors changed: {sorted(changed & frozen)[:5]}")
    if not decoder <= changed:
        raise AssertionError(f"[train] decoder tensors unchanged: {sorted(decoder - changed)[:5]}")
    med = float(np.median(times[1:]))
    log(f"[train] {TRAIN_STEPS} steps of [{TRAIN_B}x{T}x{SIZE}^2], K={TRAIN_K}, fp32: median "
        f"{med:.4f} s/step ({TRAIN_N / med:.1f} frames/s), warm-up {times[0]:.4f} s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB on {smi} (TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}); "
        f"{len(changed)} of {len(before)} tensors changed, frozen ones unchanged; launches "
        f"{counts} in {steps} steps (K4 dimg by plan {dimg_plans})")
    return {"launches": counts, "s_per_step": med, "peak_bytes": peak, "times": times,
            "dimg_plans": dimg_plans}


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
    model.eval()
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


class SharedMatching:
    """The criterion's matcher for the card-vs-CPU comparison. The CPU pass
    records its cost matrices and assignments and the card pass takes the
    CPU's assignment, so that a near-tie between two queries' matching
    costs, which float32 rounding can break either way, cannot swap the mask
    a loss is taken on (the weights come from the nondeterministic training
    steps, so such a tie shows up in some runs and not others).

    The card's own matcher still runs on the card pass, and `check` holds
    its assignment to what a tie cannot break: per frame, with delta the
    largest |C_card - C_cpu| over the frame's valid slots and K_v their
    number, an assignment optimal for C_card costs at most 2 K_v delta more
    under C_cpu than the CPU's optimum, plus the solver's float32 rounding.
    A near-tie passes; a wrong assignment fails."""

    def __init__(self, matcher):
        self.matcher, self.recorded, self.replay = matcher, [], None
        self.slots = self.differ = self.frames = 0
        self.tightest = None  # (excess over the CPU optimum, its bound, delta)

    def __getattr__(self, name):  # num_points, for the draws
        return getattr(self.matcher, name)

    def __call__(self, *args):
        from combo_avs_torch.losses.matcher import BIG_COST

        assign = self.matcher(*args)
        # the cost the matcher solves: cost_matrix, then __call__'s nan_to_num
        cost = torch.nan_to_num(self.matcher.cost_matrix(*args), nan=BIG_COST, posinf=BIG_COST,
                                neginf=-BIG_COST).double().cpu()
        if self.replay is None:
            self.recorded.append((cost, assign))
            return assign
        cost_cpu, want = self.replay.pop(0)
        self.check(cost_cpu, want, cost, assign.cpu(), args[5].cpu())
        want = want.to(assign.device)
        self.slots += want.numel()
        self.differ += int((want != assign).sum())
        return want

    def check(self, cost_cpu, assign_cpu, cost_card, assign_card, valid):
        """cost_* [N, Q, K] float64, assign_* [N, K] (-1 on an invalid
        slot), valid [N, K]; raises where the card's assignment reuses a
        query or costs more under C_cpu than the bound allows.

        The rounding term is 1e-5 x max(1, |optimum|), or the float32
        rounding bound of the card solver's sums where that is larger: the
        solver (`ops/lsap.py`) compares float32 totals of K terms, BIG_COST
        for each invalid slot included, and a sum of K terms is off by at
        most (K - 1) 2^-24 times the sum of their magnitudes, for each of
        the two totals it compares (its choice and the CPU's)."""
        from combo_avs_torch.losses.matcher import BIG_COST

        N, Q, K = cost_cpu.shape
        for n in range(N):
            ks = valid[n].nonzero().flatten()
            if not len(ks):
                continue
            q_card, q_cpu = assign_card[n, ks], assign_cpu[n, ks]
            if (len(set(q_card.tolist())) != len(ks) or int(q_card.min()) < 0
                    or int(q_card.max()) >= Q):
                raise AssertionError(f"[train-card-vs-cpu] the card's matcher assigned queries "
                                     f"{q_card.tolist()} to the {len(ks)} valid slots of a frame")
            delta = float((cost_card[n][:, ks] - cost_cpu[n][:, ks]).abs().max())
            optimum = float(cost_cpu[n, q_cpu, ks].sum())
            got = float(cost_cpu[n, q_card, ks].sum())
            big = BIG_COST * (K - len(ks))  # the invalid slots' share of each solver total
            magnitude = (float(cost_card[n, q_card, ks].abs().sum())
                         + float(cost_card[n, q_cpu, ks].abs().sum()) + 2 * big)
            rounding = max(1e-5 * max(1.0, abs(optimum)), (K - 1) * 2.0**-24 * magnitude)
            allowed = 2 * len(ks) * delta + rounding
            if got - optimum > allowed:
                raise AssertionError(f"[train-card-vs-cpu] the card's matching {q_card.tolist()} "
                                     f"costs {got:.6f} under the CPU's costs, the CPU optimum "
                                     f"{q_cpu.tolist()} {optimum:.6f}: {got - optimum:.3e} above "
                                     f"it, more than 2 K_v delta + rounding = {allowed:.3e} "
                                     f"(delta {delta:.3e})")
            self.frames += 1
            if self.tightest is None or (got - optimum) / allowed > (
                    self.tightest[0] / self.tightest[1]):
                self.tightest = (got - optimum, allowed, delta)


def phase_train_card_vs_cpu(model) -> dict:
    """The training losses and every parameter's gradient, card against CPU:
    full width, 1 video x 5 frames x 128^2, TF32 off, dropout off (eval
    mode), the same weights, the same injected draws and the CPU's matching
    (`SharedMatching`), exact top-k on both sides (the CPU always takes
    it)."""
    from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict, total_loss
    from combo_avs_torch.models.meta_arch import MaskFormer
    from combo_avs_torch.train.train_step import compute_losses

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = next(model.parameters()).device
    cpu = MaskFormer(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    batch = {k: v.cpu() for k, v in train_batch(1, TRAIN_VS_CPU_SIZE, dev, seed=SEED + 2).items()}
    crit = SetCriterion(exact_topk=True)
    matching = crit.matcher = SharedMatching(crit.matcher)
    wd = build_weight_dict()
    g = torch.Generator().manual_seed(SEED + 3)
    draws = [crit.draw(g, T, TRAIN_K) for _ in range(DEC_OUTPUTS)]
    res = {}
    for name, m in (("cpu", cpu), ("gpu", model)):
        d = next(m.parameters()).device
        if name == "gpu":
            matching.replay = list(matching.recorded)
        m.eval()
        m.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        losses = compute_losses(m, crit, batch, torch.Generator(device=d),
                                draws=[tuple(t.to(d) for t in dr) for dr in draws])
        total_loss(losses, wd).backward()
        grads = {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()
                 if p.grad is not None}
        res[name] = ({k: float(v.detach()) for k, v in losses.items()}, grads)
        log(f"[train-card-vs-cpu] {name}: losses and gradients in {time.perf_counter() - t0:.1f} s")
    model.zero_grad(set_to_none=True)
    excess, allowed, delta = matching.tightest
    log(f"[train-card-vs-cpu] the card's matcher chose another query for {matching.differ} of "
        f"{matching.slots} slots (a near-tie in the cost); both sides took the CPU's matching. "
        f"Its own assignment in each of {matching.frames} frames: distinct queries, cost under "
        f"the CPU's costs within the bound; tightest frame {excess:.3e} above the CPU optimum "
        f"against a bound of {allowed:.3e} (delta {delta:.3e})")
    (lc, gc), (lg, gg) = res["cpu"], res["gpu"]
    if set(gc) != set(gg) or set(lc) != set(lg):
        raise AssertionError("[train-card-vs-cpu] different losses or gradient sets")
    loss_err = {k: abs(lg[k] - lc[k]) / max(1.0, abs(lc[k])) for k in lc}
    worst = max(loss_err, key=loss_err.get)
    norm_all = float(torch.sqrt(sum((gc[n] ** 2).sum() for n in gc)))
    rl2 = {n: float((gg[n] - gc[n]).norm()) / max(float(gg[n].norm()), float(gc[n].norm()),
                                                  GRAD_FLOOR * norm_all)
           for n in gc}
    all_rl2 = float(torch.sqrt(sum(((gg[n] - gc[n]) ** 2).sum() for n in gc))) / norm_all
    worst_leaf = max(rl2, key=rl2.get)
    median = float(np.median(list(rl2.values())))
    log(f"[train-card-vs-cpu] {len(lc)} losses, worst {worst} rel err {loss_err[worst]:.3e} "
        f"(tol {LOSS_RTOL_CPU}); {len(gc)} gradient leaves: worst {worst_leaf} rel-L2 "
        f"{rl2[worst_leaf]:.3e} (tol {GRAD_RL2_LEAF}), median {median:.3e} (tol "
        f"{GRAD_RL2_MEDIAN}), whole gradient {all_rl2:.3e} (tol {GRAD_RL2_ALL}); TF32 off")
    if (loss_err[worst] > LOSS_RTOL_CPU or rl2[worst_leaf] > GRAD_RL2_LEAF
            or median > GRAD_RL2_MEDIAN or all_rl2 > GRAD_RL2_ALL):
        raise AssertionError("[train-card-vs-cpu] card and CPU disagree beyond the tolerances")
    return {"loss_rel_err": loss_err[worst], "grad_rl2_leaf": rl2[worst_leaf],
            "grad_rl2_median": median, "grad_rl2_all": all_rl2}


TIMING_KEYS = ("ms", "device_source", "call_ms", "host_us", "plain_ms", "library_ms",
               "library_source", "library_call_ms", "library_host_us")


def kernel_entry(name, source, replaces, launches, numbers, **extra) -> dict:
    """One kernel of the `kernels` line: `ms` is its device ms, `call_ms` one
    eager call's, `plain_ms` the plain version's call ms, `library_ms` the
    library call's device ms (null where no single call computes the function)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            **{k: numbers[k] for k in keys}, "library_ms": numbers.get("library_ms"),
            **{k: numbers[k] for k in TIMING_KEYS if k in numbers and k not in keys}, **extra}


def rank_against_library(rows) -> list:
    """Each (name, timings) with a library call, slowest against it first, by
    device ms; prints the ranking."""
    ranked = sorted(((name, t["ms"], t["library_ms"], t["ms"] / t["library_ms"])
                     for name, t in rows if t.get("library_ms")), key=lambda r: -r[3])
    for name, ms, lib, ratio in ranked:
        log(f"[rank] {name}: {ms:.4f} ms device against the library's {lib:.4f} ms: "
            f"{ratio:.2f}x ({'slower' if ratio > 1 else 'no slower'})")
    return ranked


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 only (build, each kernel against its plain version, "
                         "timings), for comparing two trees; prints no status line")
    args = ap.parse_args(argv)
    smi = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    ps = phase_point_sample(dev)
    k7 = phase_k7(dev)
    k6 = phase_k6(dev)
    with_library = ([(s["name"], s) for s in ps["fwd"]]
                    + [("k4_dimg", ps["dimg"]), ("k4_dxy", ps["dxy"]), ("k6", k6)])
    if args.kernels_only:
        rank_against_library(with_library)
        log(f"[kernels-only] done on {smi}")
        return 0

    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import MaskFormer

    t0 = time.perf_counter()
    model = init_weights(MaskFormer(), seed=SEED)  # builds on the current CUDA device
    if next(model.parameters()).device != dev:
        raise AssertionError("MaskFormer() did not build on the card")
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] MaskFormer() COMBO-R50 S4: {n_params} parameters, seeded init on "
        f"{torch.cuda.get_device_name(0)} in {time.perf_counter() - t0:.1f} s")
    sl = phase_slice(model, smi)
    ee = phase_eval_entry(model, smi)
    tr = phase_train(model, smi)
    phase_card_vs_cpu(model)
    phase_train_card_vs_cpu(model)
    # last, so that the card-vs-CPU phases see the weights of the 4 steps above
    tf = phase_train_fallback(model)

    ev, tl, fb = sl["launches"], tr["launches"], tf["launches"]
    entry = {k: ee["fp32"]["launches"][k] + ee["bf16"]["launches"][k] for k in ("k1", "k7")}
    fwd = ps["fwd"]
    per_layer = {k: sum(s[k] for s in fwd) for k in ("ms", "call_ms", "host_us", "plain_ms",
                                                     "library_ms", "library_call_ms",
                                                     "library_host_us", "bound_ms", "bytes",
                                                     "flops")}
    per_layer.update({k: "+".join(sorted({s[k] for s in fwd}))
                      for k in ("device_source", "library_source")})
    ranked = rank_against_library(with_library)
    kernels = [
        kernel_entry("ms_deform_attn_fwd", "combo_avs_torch/csrc/ms_deform_attn_fwd.cu",
                     REPLACES["k1"], {"eval": ev["k1"], "eval_entry": entry["k1"],
                                       "train": tl["k1"], "train_fallback": fb["k1"]}, k1["fp32"],
                     shape="value [20,1029,8,32] fp32", plan=k1["fp32"]["chosen"],
                     eval_launches_by_plan=sl["k1_plans"],
                     max_abs_err_bf16=k1["bf16"]["max_abs_err"],
                     ms_bf16=k1["bf16"]["ms"], call_ms_bf16=k1["bf16"]["call_ms"],
                     plain_ms_bf16=k1["bf16"]["plain_ms"], bound_ms_bf16=k1["bf16"]["bound_ms"],
                     ms_train=k1["train_fp32"]["ms"], bound_ms_train=k1["train_fp32"]["bound_ms"],
                     plans_ms={name: {kn: v["ms"] for kn, v in k1[name]["plans"].items()}
                               for name in ("fp32", "bf16", "train_fp32", "train_bf16")}),
        kernel_entry("ms_deform_attn_bwd", "combo_avs_torch/csrc/ms_deform_attn_bwd.cu",
                     REPLACES["k2"], {"eval": ev["k2"], "train": tl["k2"],
                                       "train_fallback": fb["k2"]},
                     k2["level_slice"],
                     shape="value [40,1029,8,32] fp32", plan="level_slice",
                     **{f"global_{k}": k2["global"][k] for k in ("max_abs_err", "ms", "call_ms",
                                                                 "host_us", "device_source")}),
        kernel_entry("point_sample_fwd", "combo_avs_torch/csrc/point_sample_fwd.cu",
                     REPLACES["k3"], {"eval": ev["k3"], "train": tl["k3"],
                                       "train_fallback": fb["k3"]},
                     dict(per_layer, max_abs_err=max(s["max_abs_err"] for s in fwd),
                          bound_by="bytes" if per_layer["bytes"] / PEAK_BYTES_PER_S
                          >= per_layer["flops"] / PEAK_FP32_PER_S else "operations"),
                     also_replaces=REPLACES["k5"],
                     shape="one decoder output's 5 calls, summed; each in calls",
                     calls=[{k: s[k] for k in ("name", "shape", "points", *TIMING_KEYS,
                                               "bound_ms", "bound_by", "max_abs_err")}
                            for s in fwd]),
        kernel_entry("point_sample_bwd_dimg", "combo_avs_torch/csrc/point_sample_bwd.cu",
                     REPLACES["k4"], {"eval": ev["k4_dimg"], "train": tl["k4_dimg"],
                                       "train_fallback": fb["k4_dimg"]}, ps["dimg"],
                     shape="dout [120,12544,1] into [120,56,56,1]", plan="staged",
                     train_launches_by_plan=tr["dimg_plans"],
                     plan_detail=ps["dimg"]["plan"],
                     **{f"global_{k}": ps["dimg"]["global_plan"][k]
                        for k in ("max_abs_err", "ms", "call_ms", "host_us", "device_source")},
                     also_replaces=REPLACES["k4_dxy"],
                     dxy_launches={"eval": ev["k4_dxy"], "train": tl["k4_dxy"],
                                   "train_fallback": fb["k4_dxy"]},
                     **{f"dxy_{k}": ps["dxy"][k] for k in ("max_abs_err", *TIMING_KEYS,
                                                           "bound_ms", "bound_by")}),
        kernel_entry("seminf_fwd", "combo_avs_torch/csrc/seminf_fwd.cu", REPLACES["k7"],
                     {"eval": ev["k7"], "eval_entry": entry["k7"], "train": tl["k7"]}, k7["fp32"],
                     shape="mask [20,100,56,56] fp32 -> [20,2,224,224]", plan="patch",
                     plan_detail=k7["fp32"]["plan"], eval_launches_by_plan=sl["k7_plans"],
                     resize_ms=k7["fp32"]["resize_ms"],
                     resize_call_ms=k7["fp32"]["resize_call_ms"],
                     max_abs_err_bf16=k7["bf16"]["max_abs_err"], ms_bf16=k7["bf16"]["ms"],
                     call_ms_bf16=k7["bf16"]["call_ms"], plain_ms_bf16=k7["bf16"]["plain_ms"],
                     resize_ms_bf16=k7["bf16"]["resize_ms"], bound_ms_bf16=k7["bf16"]["bound_ms"],
                     **{f"pixel_{k}{sfx}": k7[name]["pixel_plan"][k]
                        for name, sfx in (("fp32", ""), ("bf16", "_bf16"))
                        for k in ("max_abs_err", "ms", "call_ms", "host_us")}),
        kernel_entry("gather_points", "combo_avs_torch/csrc/gather.cu", REPLACES["k6"],
                     {"eval": ev["k6"], "train": tl["k6"], "train_fallback": fb["k6"]}, k6,
                     shape="src [120,37632,2] fp32, idx [120,9408] int64"),
    ]
    log(json.dumps({"train": {"s_per_step": tr["s_per_step"], "step_times_s": tr["times"],
                              "max_memory_allocated": tr["peak_bytes"],
                              "shape": f"{TRAIN_B}x{T}x{SIZE}^2 K={TRAIN_K} fp32"},
                    "eval_fps": sl["fps"], "card": smi,
                    "slower_than_library": [r[0] for r in ranked if r[3] > 1],
                    "eval_entry": {k: {"metrics": v["metrics"], "timing": v["timing"]}
                                   for k, v in ee.items()}}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
