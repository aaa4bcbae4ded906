"""PointRend point sampling on the card: the wrappers of the forward kernel
(`csrc/point_sample_fwd.cu`, the TPU's K3 and K5) and the two backward
kernels (`csrc/point_sample_bwd.cu`, the TPU's K4), and their
`torch.autograd.Function`.

`point_sample_cuda(feat [N, H, W, C], points [N, P, 2]) -> [N, P, C]` is what
`ops.grid_sample.point_sample` calls for a CUDA tensor. The forward's kernel
and its grid come from `launch_plan`, the image gradient's from
`dimg_launch_plan`: pure functions of the shapes, the inputs' alignment (and
for dimg the card's SM count and opt-in shared memory) that the CPU tests
check; the C functions only execute the plan they are given. The backward
launches
the image-gradient kernel when `feat` needs a gradient and the
point-gradient kernel only when `points` do (on the training path they never
do: the criterion's points are drawn, not learned). Every wrapper raises on a
tensor it cannot take; none falls back to the plain version.

`fwd_launches`, `dimg_launches` and `dxy_launches` count the kernels'
launches in this process, each incremented where its kernel is launched and
nowhere else; `dimg_plan_launches` splits the image gradient's by plan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from combo_avs_torch.ops import _build
from combo_avs_torch.ops.deform_attn_cuda import sm_count, smem_optin

FWD_SOURCE = "point_sample_fwd.cu"
BWD_SOURCE = "point_sample_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)

fwd_launches = 0
dimg_launches = 0
dxy_launches = 0
dimg_plan_launches = {"global": 0, "staged": 0}

_INT = ctypes.c_int
_PTR = ctypes.c_void_p
_SIGNATURES = {
    # name: (source, ctypes arguments); the forward takes its shape and launch
    # plan as one int array (_plan_args), which ctypes converts at a third of
    # the cost of 11 separate ints
    "point_sample_fwd": (FWD_SOURCE, [_PTR] * 3 + [ctypes.POINTER(_INT), _PTR]),
    "point_sample_bwd_dimg": (BWD_SOURCE, [_PTR] * 3 + [ctypes.POINTER(_INT), _PTR]),
    "point_sample_bwd_dxy": (BWD_SOURCE, [_PTR] * 4 + [_INT] * 6 + [_PTR]),
}
_bound: dict = {}  # name -> the ctypes function, bound once per process

# the forward's launch plan (csrc/point_sample_fwd.cu executes it)
THREADS = 256  # threads per block, both kernels
POINTS_PER_THREAD = 4  # the staged kernel
STAGE_BYTES = 48 * 1024  # largest image staged in shared memory (no opt-in needed)
MAX_CHANNEL_POINTS = 256  # the channels kernel's corner table
GRID_ROWS = 65535  # the grid's y limit: images beyond it loop within a block row
# points a staged block samples: its image copy is spread over that many
# (scripts/bench_point_plans.py: 4096-8192 slower, 1024 slower at the
# criterion's 37632 points and a little faster at 12544)
STAGED_POINTS_PER_BLOCK = 2 * THREADS * POINTS_PER_THREAD


class LaunchPlan(NamedTuple):
    """How `csrc/point_sample_fwd.cu` samples feat [N, H, W, C] at [N, P, 2]
    points.

    kernel: "staged" (C <= 4 and an image of at most STAGE_BYTES: the block
        copies its image into shared memory, a thread takes
        POINTS_PER_THREAD consecutive points with their C channels in
        registers) or "channels" (any other: a block takes up to
        MAX_CHANNEL_POINTS points, its threads walk their channels and
        gather the corners from global memory);
    vec: vector accesses (staged: two points in a float4, the C outputs of
        four points as C float4, corners as float2 / float4 at C = 2 / 4;
        channels: float4 channel units), else the tail-safe scalar path;
    stage16: the staging copies 16 bytes at a time (else 4);
    points_per_block, grid: the block's points, and the grid (point blocks
        per image, image rows), whose rows loop over N when N > GRID_ROWS."""

    kernel: str
    vec: bool
    stage16: bool
    points_per_block: int
    grid: Tuple[int, int]


def launch_plan(N: int, H: int, W: int, C: int, P: int, feat_ptr: int = 0,
                points_ptr: int = 0) -> LaunchPlan:
    """The forward's launch plan, a pure function of the shapes and the
    inputs' addresses (the output is a fresh, aligned allocation)."""
    rows = min(N, GRID_ROWS)
    if C <= 4 and H * W * C * 4 <= STAGE_BYTES:
        vec = points_ptr % 16 == 0 and P % 2 == 0 and (P * C) % 4 == 0
        per_block = STAGED_POINTS_PER_BLOCK
        return LaunchPlan("staged", vec, feat_ptr % 16 == 0 and (H * W * C) % 4 == 0,
                          per_block, (-(-P // per_block), rows))
    vec = C % 4 == 0 and feat_ptr % 16 == 0
    units = C // 4 if vec else C
    per_block = max(1, min(MAX_CHANNEL_POINTS, THREADS * 4 // units))
    return LaunchPlan("channels", vec, False, per_block, (-(-P // per_block), rows))


@functools.lru_cache(maxsize=1024)
def _plan_args(N: int, H: int, W: int, C: int, P: int, feat_ptr: int, points_ptr: int):
    """The C function's int array: N, H, W, C, P and launch_plan's kernel
    (0 staged, 1 channels), vec, stage16, points per block, grid x, grid y;
    made once per shape and alignment (the addresses are passed modulo 16)."""
    plan = launch_plan(N, H, W, C, P, feat_ptr, points_ptr)
    return (_INT * 11)(N, H, W, C, P, int(plan.kernel == "channels"), int(plan.vec),
                       int(plan.stage16), plan.points_per_block, *plan.grid)


# the image gradient's launch plan (csrc/point_sample_bwd.cu executes it)
DIMG_KERNELS = ("global", "staged")  # the C function's kernel codes 0, 1
MAX_STAGED_C = 4  # the staged kernel keeps a point's C gradients in registers
DIMG_THREADS = 1024  # threads per staged block
DIMG_CLUSTERS = (1, 2, 4)  # blocks per image the plan chooses from
SM_THREADS = 2048  # the threads an SM holds: the staged blocks fill one wave of them
# the least share of the SMs the staged blocks must reach at the largest
# cluster, else the global kernel, whose atomics spread over every SM, is
# faster (scripts/bench_point_bwd_plans.py, 12544 points an image: global
# faster up to 4 images, the two equal at 8, staged faster from 12)
DIMG_MIN_FILL = 0.24


class DimgLaunchPlan(NamedTuple):
    """How `csrc/point_sample_bwd.cu` computes the image gradient [N, H, W,
    C] of the forward against `grad_out` [N, P, C].

    kernel: "staged" (C <= MAX_STAGED_C, an image whose fp32 accumulator
        fits the card's opt-in shared memory, and images enough to fill
        DIMG_MIN_FILL of the SMs: a cluster of `cluster` blocks per image,
        each summing its share of the points in its shared accumulator; the
        cluster then sums its accumulators and stores the image once) or
        "global" (a group of lanes per point adds into a zeroed output with
        global atomics);
    threads: threads per block;
    cluster: blocks per image (1 for "global");
    points_per_block: the points a staged block takes (a multiple of 4; 0
        for "global");
    grid: (x, y); staged: (cluster, image rows), the rows looping over N
        when N > GRID_ROWS; global: (blocks, 1);
    vec: the staged kernel reads 4 points as two float4 and their gradients
        as C float4 (every image's points and gradients 16-byte aligned);
    smem_bytes: the staged block's dynamic shared memory (`dimg_smem_bytes`;
        0 for "global");
    log2_group: the global kernel's lanes per point, log2 (0 for "staged")."""

    kernel: str
    threads: int
    cluster: int
    points_per_block: int
    grid: Tuple[int, int]
    vec: bool
    smem_bytes: int
    log2_group: int


def dimg_smem_bytes(H: int, W: int, C: int) -> int:
    """The staged kernel's shared memory: the image's fp32 accumulator, in
    whole float4."""
    return -(-H * W * C // 4) * 16


def dimg_cluster(N: int, P: int, sm_count: int) -> int:
    """Blocks per image: the most of DIMG_CLUSTERS whose N * blocks of
    DIMG_THREADS fit one wave of the card's SMs at SM_THREADS each, else the
    fewest (scripts/bench_point_bwd_plans.py: 2 blocks an image fastest at
    120 images, 4 at 60 and fewer, 1 at 300); and no more than give every
    block at least one of the P points in runs of POINTS_PER_THREAD."""
    wave = SM_THREADS // DIMG_THREADS * sm_count
    cluster = max((c for c in DIMG_CLUSTERS if N * c <= wave), default=DIMG_CLUSTERS[0])
    while cluster > 1 and (cluster - 1) * _dimg_points_per_block(P, cluster) >= P:
        cluster //= 2
    return cluster


def _dimg_points_per_block(P: int, cluster: int) -> int:
    return -(-P // (cluster * POINTS_PER_THREAD)) * POINTS_PER_THREAD


def dimg_launch_plan(N: int, H: int, W: int, C: int, P: int, points_ptr: int, grad_ptr: int,
                     sm_count: int, smem_optin: int) -> DimgLaunchPlan:
    """The image gradient's launch plan, a pure function of the shapes, the
    inputs' addresses (the output is a fresh, aligned allocation), the
    card's SM count and its opt-in shared memory per block: "staged" when C
    <= MAX_STAGED_C, the image's accumulator fits that limit and N images
    at the largest cluster reach DIMG_MIN_FILL of the SMs; else
    "global"."""
    smem = dimg_smem_bytes(H, W, C)
    if (C <= MAX_STAGED_C and smem <= smem_optin
            and N * DIMG_CLUSTERS[-1] >= DIMG_MIN_FILL * sm_count):
        cluster = dimg_cluster(N, P, sm_count)
        vec = points_ptr % 16 == 0 and grad_ptr % 16 == 0 and P % 2 == 0 and (P * C) % 4 == 0
        return DimgLaunchPlan("staged", DIMG_THREADS, cluster, _dimg_points_per_block(P, cluster),
                              (cluster, min(N, GRID_ROWS)), vec, smem, 0)
    group = _log2_group(C)
    blocks = -(-((N * P) << group) // THREADS)
    return DimgLaunchPlan("global", THREADS, 1, 0, (blocks, 1), False, 0, group)


def dimg_plan_args(N: int, H: int, W: int, C: int, P: int, plan: DimgLaunchPlan):
    """The image gradient's C int array: N, H, W, C, P, the plan's kernel (0
    global, 1 staged), threads, cluster, points per block, grid x, grid y,
    vec, shared-memory bytes, log2_group."""
    return (_INT * 14)(N, H, W, C, P, DIMG_KERNELS.index(plan.kernel), plan.threads,
                       plan.cluster, plan.points_per_block, *plan.grid, int(plan.vec),
                       plan.smem_bytes, plan.log2_group)


@functools.lru_cache(maxsize=1024)
def _chosen_dimg_plan(N: int, H: int, W: int, C: int, P: int, points_ptr: int, grad_ptr: int,
                      sm_count: int, smem_optin: int):
    """dimg_launch_plan's choice and its int array, made once per shape and
    alignment (the addresses are passed modulo 16)."""
    plan = dimg_launch_plan(N, H, W, C, P, points_ptr, grad_ptr, sm_count, smem_optin)
    return plan, dimg_plan_args(N, H, W, C, P, plan)


def _kernel(name: str):
    fn = _bound.get(name)
    if fn is None:
        source, fn_argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(source), name)
        fn.argtypes = fn_argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _log2_group(C: int) -> int:
    """The backward kernels' lanes per point: the smallest power of two >= C,
    at most 32."""
    return min(5, max(0, (C - 1).bit_length()))


def _check(name: str, points: torch.Tensor, *others: torch.Tensor):
    """Every tensor a float32, contiguous CUDA tensor on one device; points
    [N, P, 2] with N, P >= 1. Returns (N, P)."""
    device = points.get_device()
    for t in (points, *others):
        if not t.is_cuda or t.get_device() != device:
            raise ValueError(f"{name}: every input must be a CUDA tensor, all on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    shape = points.shape
    if len(shape) != 3 or shape[2] != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"{name}: points must be [N, P, 2], got {tuple(shape)}")
    return shape[0], shape[1]


def _check_image(name: str, N: int, H: int, W: int, C: int, P: int) -> None:
    if H < 1 or W < 1 or C < 1 or H * W * C >= 2**31 or P * max(C, 2) >= 2**31:
        raise ValueError(f"{name}: image [{N}, {H}, {W}, {C}] at {P} points is empty or too "
                         "large for 32-bit offsets within an image")


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def point_sample_fwd_cuda(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: feat [N, H, W, C] at points [N, P, 2] in
    [0, 1] -> [N, P, C], all float32 and contiguous."""
    global fwd_launches
    N, P = _check("point_sample_fwd_cuda", points, feat)
    shape = feat.shape
    if len(shape) != 4 or shape[0] != N:
        raise ValueError(f"point_sample_fwd_cuda: feat must be [N, H, W, C] with N = {N}, "
                         f"got {tuple(shape)}")
    _, H, W, C = shape
    _check_image("point_sample_fwd_cuda", N, H, W, C, P)
    out = feat.new_empty((N, P, C))
    fp, pp = feat.data_ptr(), points.data_ptr()
    plan = _plan_args(N, H, W, C, P, fp % 16, pp % 16)
    err = _kernel("point_sample_fwd")(fp, pp, out.data_ptr(), plan, _stream(feat))
    if err != 0:
        raise RuntimeError(f"point_sample_fwd launch failed: CUDA error {err} "
                           f"(plan {list(plan)})")
    fwd_launches += 1
    return out


def point_sample_dimg_cuda(points: torch.Tensor, grad_out: torch.Tensor, image_hw,
                           plan: Optional[DimgLaunchPlan] = None) -> torch.Tensor:
    """Launch the image-gradient kernel: the gradient [N, H, W, C] of the
    forward's output against `grad_out` [N, P, C]. `plan` is
    `dimg_launch_plan`'s choice unless the caller names another (to check
    or time it); a launch that fails raises, whatever the plan."""
    global dimg_launches
    N, P = _check("point_sample_dimg_cuda", points, grad_out)
    H, W = (int(n) for n in image_hw)
    if grad_out.dim() != 3 or tuple(grad_out.shape[:2]) != (N, P):
        raise ValueError(f"point_sample_dimg_cuda: grad_out must be [{N}, {P}, C], got "
                         f"{tuple(grad_out.shape)}")
    C = grad_out.shape[2]
    _check_image("point_sample_dimg_cuda", N, H, W, C, P)
    pp, gp = points.data_ptr(), grad_out.data_ptr()
    if plan is None:
        index = grad_out.get_device()
        plan, args = _chosen_dimg_plan(N, H, W, C, P, pp % 16, gp % 16, sm_count(index),
                                       smem_optin(index))
    else:
        args = dimg_plan_args(N, H, W, C, P, plan)
    # the staged kernel writes every element; the global one adds into zeros
    dfeat = (torch.empty if plan.kernel == "staged" else torch.zeros)(
        (N, H, W, C), dtype=torch.float32, device=grad_out.device)
    err = _kernel("point_sample_bwd_dimg")(pp, gp, dfeat.data_ptr(), args, _stream(grad_out))
    if err != 0:
        raise RuntimeError(f"point_sample_bwd_dimg ({plan.kernel}) launch failed: CUDA error "
                           f"{err} (plan {list(args)})")
    dimg_launches += 1
    dimg_plan_launches[plan.kernel] += 1
    return dfeat


def point_sample_dxy_cuda(feat: torch.Tensor, points: torch.Tensor,
                          grad_out: torch.Tensor) -> torch.Tensor:
    """Launch the point-gradient kernel: the gradient [N, P, 2] of the
    forward's output against `grad_out` [N, P, C]."""
    global dxy_launches
    N, P = _check("point_sample_dxy_cuda", points, feat, grad_out)
    if feat.dim() != 4 or feat.shape[0] != N or tuple(grad_out.shape) != (N, P, feat.shape[3]):
        raise ValueError(f"point_sample_dxy_cuda: feat {tuple(feat.shape)} and grad_out "
                         f"{tuple(grad_out.shape)} do not match points {tuple(points.shape)}")
    _, H, W, C = feat.shape
    _check_image("point_sample_dxy_cuda", N, H, W, C, P)
    dpoints = torch.empty((N, P, 2), dtype=torch.float32, device=feat.device)
    err = _kernel("point_sample_bwd_dxy")(feat.data_ptr(), points.data_ptr(),
                                          grad_out.data_ptr(), dpoints.data_ptr(),
                                          N, H, W, C, P, _log2_group(C), _stream(feat))
    if err != 0:
        raise RuntimeError(f"point_sample_bwd_dxy launch failed: CUDA error {err}")
    dxy_launches += 1
    return dpoints


class PointSampleFunction(torch.autograd.Function):
    """Forward kernel; backward through the image-gradient kernel and, when
    the points need a gradient, the point-gradient kernel."""

    @staticmethod
    def forward(ctx, feat, points):
        ctx.save_for_backward(feat, points)
        return point_sample_fwd_cuda(feat, points)

    @staticmethod
    def backward(ctx, grad_out):
        feat, points = ctx.saved_tensors
        g = grad_out.contiguous()
        dfeat = dpoints = None
        if ctx.needs_input_grad[0]:
            dfeat = point_sample_dimg_cuda(points, g, feat.shape[1:3])
        if ctx.needs_input_grad[1]:
            dpoints = point_sample_dxy_cuda(feat, points, g)
        return dfeat, dpoints


def point_sample_cuda(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """feat [N, H, W, C] at points [N, P, 2] in [0, 1] -> [N, P, C] on the
    card, differentiable in both inputs."""
    if torch.is_grad_enabled() and (feat.requires_grad or points.requires_grad):
        return PointSampleFunction.apply(feat, points)
    return point_sample_fwd_cuda(feat, points)  # no graph to record: skip the Function
