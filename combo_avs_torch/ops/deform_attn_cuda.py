"""Multi-scale deformable attention on the card: the wrappers of the K1
forward and K2 backward kernels, their `torch.autograd.Function`, and the
device dispatch.

`ms_deform_attn` is what the model calls. A CUDA tensor goes through
`MSDeformAttnFunction`, whose forward launches `csrc/ms_deform_attn_fwd.cu` and whose
backward launches `csrc/ms_deform_attn_bwd.cu` (or raise); a CPU tensor takes
the plain version `ops.deform_attn.ms_deform_attn_plain`, differentiated by
autograd. There is no fallback from one to the other.

The forward has three plans on two kernels: "staged" (each (frame, head)
value slice copied to shared memory, a 32-warp block per (frame, head,
query chunk)), "grouped" (the staged kernel where that block does not fit:
a smaller block on the whole slice or, in fp32, on a channel group of it)
and "global" (corner rows gathered from global memory); `fwd_launch_plan`
picks one, and the query chunk, block size and groups. The backward has
two kernels, "level_slice" (dvalue summed per (frame, head, level) in shared
memory) and "global" (global atomics); `bwd_launch_plan` picks one. Both plans are pure
functions of the shapes and the card's opt-in shared-memory limit (and, for
the forward, its SM count), made once per shape, and the C functions only
execute them.

`launches` and `bwd_launches` count the two kernels' launches in this
process, `fwd_plan_launches` and `bwd_plan_launches` each kernel's by
plan, and `bwd_dtype_launches` the backward's by value type: each is
incremented where its kernel is launched and nowhere else, so a caller can
reset them, run the model, and see that the path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from combo_avs_torch.ops import _build
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

SOURCE = "ms_deform_attn_fwd.cu"
BWD_SOURCE = "ms_deform_attn_bwd.cu"
MAX_LEVELS = 4

launches = 0
bwd_launches = 0
fwd_plan_launches = {"staged": 0, "grouped": 0, "global": 0}
bwd_plan_launches = {"level_slice": 0, "global": 0}
bwd_dtype_launches = {"float32": 0, "bfloat16": 0}

# the forward's launch plans (csrc/ms_deform_attn_fwd.cu executes them)
FWD_KERNELS = ("global", "staged", "grouped")  # the C function's kernel codes 0, 1, 2
FWD_GLOBAL_THREADS = 256  # the global kernel: 8 warps, one (q, m) pair each
STAGED_THREADS = 1024  # the staged kernel: 32 warps (8 and 16 are slower)
# query chunks per (frame, head): the fewest, up to MAX_CHUNKS, whose blocks
# fill their waves of one block per SM to WAVE_FILL; more chunks re-stage the
# slice more often (scripts/bench_deform_fwd_plans.py: 3 at 20 frames x 8
# heads, 2 at 40, on 132 SMs, in fp32 and bf16)
MAX_CHUNKS = 8
WAVE_FILL = 0.9
# the grouped plan, for a slice that the staged plan's 32-warp block cannot
# hold: the fewest channel groups (1: the whole slice) whose block holds at
# least this many warps, a multiple of 4 (the SM's four schedulers), and
# the fewest chunks whose blocks fill their waves to GROUPED_WAVE_FILL
# (scripts/bench_deform_fwd_plans.py at TTA's 384^2 shapes: the whole bf16
# slice at 24 warps in 4 chunks, 2 fp32 groups at 24 warps in 2 chunks;
# more groups, fewer warps or fewer chunks are slower)
GROUPED_MIN_WARPS = 24
GROUPED_WAVE_FILL = 0.95

# the backward's launch plans (csrc/ms_deform_attn_bwd.cu executes them)
GLOBAL_THREADS = 256  # the global kernel: 8 warps, one (q, m) pair each
# the level-slice kernel: 24 warps, a lane per sampling point (8 and 16 are
# slower; 32 do not fit beside the grad rows at the training shape:
# scripts/bench_deform_bwd_plans.py)
LEVEL_SLICE_THREADS = 768


# the C functions' parameters: tensor pointers, the plan's int array, the stream
FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


def _fwd_kernel():
    fn = _build.load(SOURCE).ms_deform_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = FWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel():
    fn = _build.load(BWD_SOURCE).ms_deform_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """The largest dynamic shared memory a block may opt in to on the card
    (232,448 bytes on an H100)."""
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class FwdLaunchPlan(NamedTuple):
    """How `csrc/ms_deform_attn_fwd.cu` computes K1.

    kernel: "staged" (one 32-warp block per (frame, head, query chunk)
        copies the head's whole value slice into dynamic shared memory and
        computes the chunk's queries from it), "grouped" (the staged kernel
        where that block does not fit: a block of 24-32 warps per (frame,
        head, query chunk, channel group) stages the slice's D / groups
        channels of that group, all of them when groups is 1, as in bf16)
        or "global"
        (one warp per (frame, query, head) gathers corner rows from global
        memory);
    threads: threads per block;
    chunk: queries per block (0 for "global");
    blocks_per_frame: the grid's x extent; the grid has one row per frame;
    smem_bytes: dynamic shared memory per block (`staged_bytes`; 0 for
        "global");
    groups: channel groups per (frame, head) (1 for "staged", "global"
        and bf16)."""

    kernel: str
    threads: int
    chunk: int
    blocks_per_frame: int
    smem_bytes: int
    groups: int = 1


def staged_lanes(D: int, esize: int) -> int:
    """Lanes a query takes in the staged kernel over D staged channels: one
    per 4 channels when D is a multiple of 4 (a float4, or 4 bf16 values),
    else one per bf16 pair (even D) or per channel; rounded up to a power of
    two and at most 32 (a lane then loops over the channels)."""
    vec = 4 if D % 4 == 0 else 2 if esize == 2 and D % 2 == 0 else 1
    return min(32, 1 << (-(-D // vec) - 1).bit_length())


def staged_bytes(levels: Sequence[Tuple[int, int]], D: int, P: int, esize: int,
                 threads: int = STAGED_THREADS, groups: int = 1) -> int:
    """The staged kernel's dynamic shared memory for a block that stages Dg
    = D / groups channels: the rows, S of Dg elements of `esize` bytes,
    rounded up to 16 bytes, and each warp's corner table, 32 B a point for
    each of its 32 / staged_lanes(D) queries (a grouped block keeps the
    whole slice's lanes a query, each lane taking fewer channels, so its
    tables are the staged plan's at the same warps)."""
    S = sum(h * w for h, w in levels)
    table = threads // 32 * (32 // staged_lanes(D, esize)) * len(levels) * P * 32
    return -(-S * (D // groups) * esize // 16) * 16 + table


def grouped_fits(D: int, esize: int, groups: int) -> bool:
    """Whether D splits into `groups` channel groups for the grouped plan
    (1: the whole slice): for 2 groups or more, fp32 only (bf16's whole
    slice at 24 warps was faster than 2 groups at 32, and the TTA's bf16
    slice fits whole), each group's channels a multiple of the staged
    lanes, at most 4 a lane, and its rows a multiple of 16 bytes (copied 16
    bytes at a time)."""
    if groups == 1:
        return True
    if esize != 4:
        return False
    lanes = staged_lanes(D, esize)
    Dg = D // groups
    return (D % groups == 0 and Dg % lanes == 0 and Dg // lanes in (1, 2, 4)
            and Dg * esize % 16 == 0)


def staged_chunks(B: int, Lq: int, M: int, sms: int, groups: int = 1,
                  wave_fill: float = WAVE_FILL) -> int:
    """Query chunks per (frame, head) for the staged kernel: the fewest, up
    to MAX_CHUNKS, whose B * M * groups * chunks blocks fill their waves of
    one block per SM to `wave_fill`, else the count that fills them best."""
    def fill(chunks):
        blocks = B * M * groups * -(-Lq // -(-Lq // chunks))
        return blocks / (-(-blocks // sms) * sms)

    counts = range(1, min(MAX_CHUNKS, Lq) + 1)
    return next((c for c in counts if fill(c) >= wave_fill), max(counts, key=fill))


def staged_plan(levels: Sequence[Tuple[int, int]], Lq: int, M: int, D: int, P: int, esize: int,
                threads: int, chunks: int, groups: int = 1,
                kernel: str = "staged") -> FwdLaunchPlan:
    """The staged kernel under plan `kernel` ("staged" takes groups 1) at a
    given block size, query chunk count and channel groups per (frame,
    head)."""
    chunk = -(-Lq // chunks)
    return FwdLaunchPlan(kernel, threads, chunk, M * groups * -(-Lq // chunk),
                         staged_bytes(levels, D, P, esize, threads, groups), groups)


def grouped_layout(levels: Sequence[Tuple[int, int]], D: int, P: int, esize: int,
                   smem_optin: int):
    """(groups, threads) of the grouped plan: the fewest channel groups that
    `grouped_fits` takes (1 first: the whole slice) whose rows and the
    corner tables of at least GROUPED_MIN_WARPS warps fit the opt-in limit,
    at the most warps that fit, a multiple of 4 up to 32; None if none
    does."""
    for groups in range(1, D + 1):
        if not grouped_fits(D, esize, groups):
            continue
        fits = [w for w in range(32, GROUPED_MIN_WARPS - 1, -4)
                if staged_bytes(levels, D, P, esize, 32 * w, groups) <= smem_optin]
        if fits:
            return groups, 32 * fits[0]
    return None


def fwd_launch_plan(levels: Sequence[Tuple[int, int]], B: int, Lq: int, M: int, D: int, P: int,
                    esize: int, smem_optin: int, sms: int) -> FwdLaunchPlan:
    """The forward's launch plan, a pure function of the level shapes, the
    frames, the query count, heads, channels, points per level, value's
    element size (4 fp32, 2 bf16), and the card's opt-in shared-memory limit
    per block and SM count: "staged" when its shared memory fits that limit,
    its queries cut into `staged_chunks`; else "grouped" when a smaller
    block of the whole slice or of a channel group fits (`grouped_layout`),
    its chunks counted over the groups' blocks; else "global". A caller
    names another plan by passing it to `ms_deform_attn_cuda`."""
    if staged_bytes(levels, D, P, esize) <= smem_optin:
        return staged_plan(levels, Lq, M, D, P, esize, STAGED_THREADS,
                           staged_chunks(B, Lq, M, sms))
    layout = grouped_layout(levels, D, P, esize, smem_optin)
    if layout is not None:
        groups, threads = layout
        return staged_plan(levels, Lq, M, D, P, esize, threads,
                           staged_chunks(B, Lq, M, sms, groups, GROUPED_WAVE_FILL), groups,
                           "grouped")
    return FwdLaunchPlan("global", FWD_GLOBAL_THREADS, 0,
                         -(-(Lq * M) // (FWD_GLOBAL_THREADS // 32)), 0)


def fwd_plan_args(B: int, S: int, Lq: int, M: int, D: int, P: int, esize: int,
                  levels: Sequence[Tuple[int, int]], plan: FwdLaunchPlan):
    """The forward C function's int array: B, S, Lq, M, D, L, P, dtype (0
    fp32, 1 bf16), the plan's kernel (0 global, 1 staged, 2 grouped),
    threads, query chunk, blocks per frame, shared-memory bytes and channel
    groups, then (H_l, W_l) per level."""
    return (ctypes.c_int * (14 + 2 * len(levels)))(
        B, S, Lq, M, D, len(levels), P, int(esize == 2), FWD_KERNELS.index(plan.kernel),
        plan.threads, plan.chunk, plan.blocks_per_frame, plan.smem_bytes, plan.groups,
        *[n for hw in levels for n in hw])


@functools.lru_cache(maxsize=1024)
def _chosen_fwd_plan(B: int, S: int, Lq: int, M: int, D: int, P: int, esize: int,
                     levels: Tuple[Tuple[int, int], ...], optin: int, sms: int):
    """fwd_launch_plan's choice and its int array, made once per shape."""
    plan = fwd_launch_plan(levels, B, Lq, M, D, P, esize, optin, sms)
    return plan, fwd_plan_args(B, S, Lq, M, D, P, esize, levels, plan)


class BwdLaunchPlan(NamedTuple):
    """How `csrc/ms_deform_attn_bwd.cu` computes K2.

    kernel: "level_slice" (one block per (frame, head, level) stages the
        level's value rows and sums its dvalue rows in dynamic shared
        memory, and stores them once) or "global" (one warp per (frame,
        query, head) adds into a zeroed dvalue with global atomics);
    threads: threads per block;
    blocks_per_frame: the grid's x extent; the grid has one row per frame;
    smem_bytes: dynamic shared memory per block (`level_slice_bytes`; 0 for
        "global")."""

    kernel: str
    threads: int
    blocks_per_frame: int
    smem_bytes: int


def level_slice_bytes(rows: int, D: int, P: int, threads: int = LEVEL_SLICE_THREADS,
                      esize: int = 4) -> int:
    """The level-slice kernel's shared memory for a largest level of `rows`
    positions: its value rows ([rows, D] of `esize` bytes, 4 fp32 or 2 bf16,
    rounded up to 16 bytes), its dvalue rows ([rows, D] float32) and each
    warp's grad rows (32 // P queries of D floats)."""
    return -(-rows * D * esize // 16) * 16 + (rows + threads // 32 * (32 // P)) * D * 4


def bwd_launch_plan(levels: Sequence[Tuple[int, int]], Lq: int, M: int, D: int, P: int,
                    smem_optin: int, esize: int = 4) -> BwdLaunchPlan:
    """The backward's launch plan, a pure function of the level shapes, the
    query count, heads, channels, points per level, the card's opt-in
    shared-memory limit per block and value's element size (4 fp32, 2
    bf16): "level_slice" when its shared memory for the largest level fits
    that limit, else "global"."""
    smem = level_slice_bytes(max(h * w for h, w in levels), D, P, esize=esize)
    if smem <= smem_optin:
        return BwdLaunchPlan("level_slice", LEVEL_SLICE_THREADS, M * len(levels), smem)
    warps = GLOBAL_THREADS // 32
    return BwdLaunchPlan("global", GLOBAL_THREADS, -(-(Lq * M) // warps), 0)


def plan_args(B: int, S: int, Lq: int, M: int, D: int, P: int,
              levels: Sequence[Tuple[int, int]], plan: BwdLaunchPlan, esize: int = 4):
    """The C function's int array: B, S, Lq, M, D, L, P, dtype (0 fp32, 1
    bf16), the plan's kernel (0 global, 1 level_slice), threads, blocks per
    frame and shared-memory bytes, then (H_l, W_l) per level."""
    return (ctypes.c_int * (12 + 2 * len(levels)))(
        B, S, Lq, M, D, len(levels), P, int(esize == 2), int(plan.kernel == "level_slice"),
        plan.threads, plan.blocks_per_frame, plan.smem_bytes, *[n for hw in levels for n in hw])


@functools.lru_cache(maxsize=1024)
def _chosen_plan(B: int, S: int, Lq: int, M: int, D: int, P: int, esize: int,
                 levels: Tuple[Tuple[int, int], ...], optin: int):
    """bwd_launch_plan's choice and its int array, made once per shape."""
    plan = bwd_launch_plan(levels, Lq, M, D, P, optin, esize)
    return plan, plan_args(B, S, Lq, M, D, P, levels, plan, esize)


def _check(value, spatial_shapes, sampling_locations, attention_weights, name):
    """Validate what both kernels take; returns the level shapes as ints."""
    tensors = (value, sampling_locations, attention_weights)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: every input must be a CUDA tensor")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs lie on different devices")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: value must be float32 or bfloat16, got {value.dtype}")
    if value.dim() != 4 or sampling_locations.dim() != 6 or attention_weights.dim() != 5:
        raise ValueError(f"{name}: expected value [B,S,M,D], locations "
                         "[B,Lq,M,L,P,2], weights [B,Lq,M,L,P]")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if (sampling_locations.shape[0] != B or sampling_locations.shape[2] != M
            or sampling_locations.shape[-1] != 2
            or tuple(attention_weights.shape) != (B, Lq, M, L, P)):
        raise ValueError(f"{name}: shapes disagree: value {tuple(value.shape)}, "
                         f"locations {tuple(sampling_locations.shape)}, "
                         f"weights {tuple(attention_weights.shape)}")
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if len(shapes) != L or not 1 <= L <= MAX_LEVELS or L * P > 32:
        raise ValueError(f"{name}: takes 1..{MAX_LEVELS} levels with "
                         f"levels*points <= 32, got shapes {shapes} and P={P}")
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"{name}: value length {S} != sum of spatial shapes {shapes}")
    if not value.is_contiguous():
        raise ValueError(f"{name}: value must be contiguous")
    if B * S * M * D >= 2**31 or B * Lq * M * L * P * 2 >= 2**31:
        raise ValueError(f"{name}: tensors too large for 32-bit row indices")
    if B > 65535:
        raise ValueError(f"{name}: {B} frames, more than the grid's 65535 rows")
    return shapes


def ms_deform_attn_cuda(
    value: torch.Tensor,  # [B, S, M, D] fp32 or bf16, CUDA, contiguous
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, M, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Lq, M, L, P]
    plan: Optional[FwdLaunchPlan] = None,
) -> torch.Tensor:
    """Launch K1; returns [B, Lq, M * D] in value's dtype. Not differentiable
    by itself: `MSDeformAttnFunction` pairs it with K2. `plan` is
    `fwd_launch_plan`'s choice unless the caller names another (to check or
    time it); a launch that fails raises, whatever the plan."""
    global launches
    shapes = _check(value, spatial_shapes, sampling_locations, attention_weights,
                    "ms_deform_attn_cuda")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    # the kernel reads fp32 locations and weights (the TPU path promotes them too)
    loc = sampling_locations.detach().to(torch.float32).contiguous()
    attw = attention_weights.detach().to(torch.float32).contiguous()
    # every kernel writes each output element once
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    esize = value.element_size()
    if plan is None:
        plan, args = _chosen_fwd_plan(B, S, Lq, M, D, P, esize, tuple(shapes),
                                      smem_optin(value.device.index),
                                      sm_count(value.device.index))
    else:
        args = fwd_plan_args(B, S, Lq, M, D, P, esize, shapes, plan)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = _fwd_kernel()(value.data_ptr(), loc.data_ptr(), attw.data_ptr(), out.data_ptr(), args,
                        stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_fwd ({plan.kernel}) launch failed: CUDA error {err}")
    launches += 1
    fwd_plan_launches[plan.kernel] += 1
    return out


def ms_deform_attn_bwd_cuda(value, spatial_shapes, sampling_locations, attention_weights,
                            grad_out, plan: Optional[BwdLaunchPlan] = None):
    """Launch K2: the gradients (dvalue, dlocations, dweights) of K1's output
    against `grad_out` [B, Lq, M * D], in the inputs' dtypes. A float32 or
    bfloat16 value (the bf16 AMP training step); `grad_out` is read in the
    value's type, and the kernel sums in fp32 whatever the type. `plan` is
    `bwd_launch_plan`'s choice unless the caller names another (to check or
    time it); a launch that fails raises, whatever the plan."""
    global bwd_launches
    shapes = _check(value, spatial_shapes, sampling_locations, attention_weights,
                    "ms_deform_attn_bwd_cuda")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if tuple(grad_out.shape) != (B, Lq, M * D) or grad_out.device != value.device:
        raise ValueError(f"ms_deform_attn_bwd_cuda: grad_out {tuple(grad_out.shape)} on "
                         f"{grad_out.device}, expected {(B, Lq, M * D)} on {value.device}")
    loc = sampling_locations.detach().to(torch.float32).contiguous()
    attw = attention_weights.detach().to(torch.float32).contiguous()
    g = grad_out.detach().to(value.dtype).contiguous()
    dloc = torch.empty_like(loc)
    dattw = torch.empty_like(attw)
    if g.numel() and value.numel():
        esize = value.element_size()
        if plan is None:
            plan, args = _chosen_plan(B, S, Lq, M, D, P, esize, tuple(shapes),
                                      smem_optin(value.device.index))
        else:
            args = plan_args(B, S, Lq, M, D, P, shapes, plan, esize)
        # the level-slice kernel writes every element in the value's type; the
        # global one adds into a zeroed fp32 buffer, cast below
        if plan.kernel == "level_slice":
            dvalue = torch.empty_like(value)
        else:
            dvalue = torch.zeros_like(value, dtype=torch.float32)
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = _bwd_kernel()(value.data_ptr(), loc.data_ptr(), attw.data_ptr(), g.data_ptr(),
                            dvalue.data_ptr(), dloc.data_ptr(), dattw.data_ptr(), args, stream)
        if err != 0:
            raise RuntimeError(f"ms_deform_attn_bwd ({plan.kernel}) launch failed: "
                               f"CUDA error {err}")
        bwd_launches += 1
        bwd_plan_launches[plan.kernel] += 1
        bwd_dtype_launches[str(value.dtype).removeprefix("torch.")] += 1
        dvalue = dvalue.to(value.dtype)
    else:
        dvalue = torch.zeros_like(value)
        dloc.zero_()
        dattw.zero_()
    return (dvalue, dloc.to(sampling_locations.dtype),
            dattw.to(attention_weights.dtype))


class MSDeformAttnFunction(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = tuple(spatial_shapes)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attw = ctx.saved_tensors
        dvalue, dloc, dattw = ms_deform_attn_bwd_cuda(value, ctx.spatial_shapes, loc, attw,
                                                      grad_out)
        return dvalue, None, dloc, dattw


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """Device dispatch: K1 (and K2 for its gradient) for a CUDA value, the
    plain version for a CPU one."""
    if not value.is_cuda:
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    return MSDeformAttnFunction.apply(value, spatial_shapes, sampling_locations, attention_weights)
