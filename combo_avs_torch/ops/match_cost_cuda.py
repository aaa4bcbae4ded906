"""The Hungarian matcher's cost matrix on the card: the wrapper of
`csrc/match_cost.cu`, one kernel that samples each frame's predicted masks
at its shared points (K5's arithmetic) and sums the sigmoid-CE and dice
costs without writing the [N, P, Q] samples, then adds the class cost,
BIG_COST on invalid slots and `nan_to_num` in its epilogue.

`match_cost_cuda(points, pred_logits, pred_masks, tgt_points, tgt_labels,
tgt_valid, weights) -> [N, Q, K]` is what `losses.matcher.HungarianMatcher`
solves for a call that `kernel_takes`; every other call (a CPU tensor, more
than MAX_K slots, maps too large to stage) runs the plain composition,
`HungarianMatcher.cost_matrix` and `nan_to_num`, which is also the kernel's
oracle on the card. The target masks come sampled at the same
points (`tgt_points [N, P, K]`, one K3 call).

The grid and the queries a block stages come from `launch_plan`, a pure
function of the shapes that the CPU tests check; the C function only
executes the plan it is given.

`launches` counts the kernel's launches in this process, incremented where
it is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from combo_avs_torch.ops import _build

SOURCE = "match_cost.cu"
MAX_K = 16  # the most target slots the accumulators hold (AVSS pads to 12)
THREADS, WARPS = 256, 8
# the staged maps of a block at most: two blocks an SM (228 KB of shared
# memory, 1 KB of it reserved a block)
STAGE_BYTES = 112 * 1024
_PTR = ctypes.c_void_p
ARGTYPES = [_PTR] * 7 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_float] * 3 + [_PTR]

launches = 0


def slots(K: int) -> int:
    """The slots a thread's accumulators hold (the kernel's template): 3 up
    to K = 3 (S4 and MS3), else 16 (AVSS's 12); slots past K stay zero."""
    return 3 if K <= 3 else 16


def queries_per_block(K: int) -> int:
    """Queries a block stages: 8 while a thread's 3K + 1 accumulators for
    each stay in registers (K <= 3), else 2."""
    return 8 if K <= 3 else 2


def kernel_takes(device_type: str, mask_hw: Sequence[int], K: int) -> bool:
    """Whether the kernel computes a call whose predicted masks lie on
    `device_type` as maps of `mask_hw`, against K target slots: CUDA,
    1 <= K <= MAX_K, and a block's maps within STAGE_BYTES (every 56^2
    training mask). The dtype does not route: on the card both routes take
    float32 masks, points and target masks only (K5, the composition's
    sampler, refuses any other), and the train step hands the criterion
    float32 outputs under AMP too."""
    h, w = (int(s) for s in mask_hw)
    return (device_type == "cuda" and 1 <= K <= MAX_K
            and h * w * queries_per_block(K) * 4 <= STAGE_BYTES)


class LaunchPlan(NamedTuple):
    """How `csrc/match_cost.cu` computes [N, Q, K].

    slots: the accumulators' slots KC (`slots`); queries: the queries QB a
    block stages (`queries_per_block`); chunks: blocks a frame, ceil(Q /
    QB); blocks: N * chunks, the grid; smem_bytes: dynamic shared memory,
    the QB staged maps or the reduction's (WARPS + 1) x (QB (3 KC + 1) + KC)
    floats, the larger."""

    slots: int
    queries: int
    chunks: int
    blocks: int
    smem_bytes: int


def launch_plan(N: int, Q: int, H: int, W: int, K: int) -> LaunchPlan:
    """The launch plan, a pure function of the shapes."""
    kc, qb = slots(K), queries_per_block(K)
    chunks = -(-Q // qb)
    reduce_floats = (WARPS + 1) * (qb * (3 * kc + 1) + kc)
    return LaunchPlan(kc, qb, chunks, N * chunks, 4 * max(H * W * qb, reduce_floats))


def plan_args(N: int, Q: int, H: int, W: int, P: int, K: int, C1: int, plan: LaunchPlan):
    """The C function's int array: N, Q, H, W, P, K, C1, then the plan's
    slots, queries, chunks and shared-memory bytes."""
    return (ctypes.c_int * 11)(N, Q, H, W, P, K, C1, plan.slots, plan.queries, plan.chunks,
                               plan.smem_bytes)


@functools.lru_cache(maxsize=256)
def _plan_args(N: int, Q: int, H: int, W: int, P: int, K: int, C1: int):
    """launch_plan's int array, made once per shape."""
    return plan_args(N, Q, H, W, P, K, C1, launch_plan(N, Q, H, W, K))


def _kernel():
    fn = _build.load(SOURCE).match_cost
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def match_cost_cuda(points: torch.Tensor, pred_logits: torch.Tensor, pred_masks: torch.Tensor,
                    tgt_points: torch.Tensor, tgt_labels: torch.Tensor, tgt_valid: torch.Tensor,
                    weights: Sequence[float]) -> torch.Tensor:
    """Launch the kernel: points [N, P, 2] in [0, 1], pred_masks [N, Q, h, w]
    and tgt_points [N, P, K] (the target masks sampled at `points`), all
    float32; pred_logits [N, Q, C+1] of any float type (taken as float32);
    tgt_labels [N, K] integer in [0, C+1), tgt_valid [N, K] bool; weights
    (class, mask, dice) -> [N, Q, K] float32, the matcher's cost after
    BIG_COST and nan_to_num. A launch that fails raises; a label out of
    range stops the kernel, as torch.gather's device assert does in the
    composition."""
    global launches
    tensors = (points, pred_logits, pred_masks, tgt_points, tgt_labels, tgt_valid)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("match_cost_cuda: every input must be a CUDA tensor, all on one device")
    if any(t.dtype != torch.float32 for t in (points, pred_masks, tgt_points)):
        raise TypeError("match_cost_cuda: points, masks and target points must be float32")
    if not pred_logits.dtype.is_floating_point:
        raise TypeError("match_cost_cuda: pred_logits must be a float tensor")
    if pred_masks.dim() != 4 or points.dim() != 3 or points.shape[2] != 2:
        raise ValueError(f"match_cost_cuda: pred_masks {tuple(pred_masks.shape)} must be [N, Q, "
                         f"h, w] and points {tuple(points.shape)} [N, P, 2]")
    N, Q, H, W = pred_masks.shape
    P = points.shape[1]
    K = tgt_labels.shape[-1]
    C1 = pred_logits.shape[-1]
    for name, t, shape in (("points", points, (N, P, 2)), ("pred_logits", pred_logits, (N, Q, C1)),
                           ("tgt_points", tgt_points, (N, P, K)), ("tgt_valid", tgt_valid, (N, K))):
        if tuple(t.shape) != shape:
            raise ValueError(f"match_cost_cuda: {name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if not kernel_takes("cuda", (H, W), K) or min(N, Q, P, C1) < 1:
        raise ValueError(f"match_cost_cuda: takes 1 <= K <= {MAX_K} slots and maps a block "
                         f"can stage; got K = {K}, maps {H}x{W}, N={N} Q={Q} P={P} C+1={C1}")
    if tgt_valid.dtype != torch.bool or tgt_labels.dtype.is_floating_point:
        raise TypeError("match_cost_cuda: tgt_valid must be bool and tgt_labels integer")
    masks, pts, tgt = pred_masks.contiguous(), points.contiguous(), tgt_points.contiguous()
    logits = pred_logits.to(torch.float32).contiguous()
    labels = tgt_labels.to(torch.int64).contiguous()
    valid = tgt_valid.contiguous()
    out = torch.empty((N, Q, K), dtype=torch.float32, device=masks.device)
    args = _plan_args(N, Q, H, W, P, K, C1)
    w_class, w_mask, w_dice = (float(w) for w in weights)
    err = _kernel()(masks.data_ptr(), pts.data_ptr(), tgt.data_ptr(), logits.data_ptr(),
                    labels.data_ptr(), valid.data_ptr(), out.data_ptr(), args, w_class, w_mask,
                    w_dice, torch.cuda.current_stream(masks.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"match_cost launch failed: CUDA error {err} (plan {list(args)})")
    launches += 1
    return out
