"""Which matcher calls the fused cost kernel (`ops/match_cost_cuda.py`,
`csrc/match_cost.cu`) takes, on the CPU: the dispatch rule, the launch plan,
the C signature, and that the CPU runs the plain composition without
building anything. The kernel itself is held to the composition on the card
(tests/test_torch_matchcost_card.py)."""

import pytest
import torch

from combo_avs_torch.losses.matcher import BIG_COST, HungarianMatcher, _targets_nhwc
from combo_avs_torch.ops import _build, match_cost_cuda
from combo_avs_torch.ops.grid_sample import point_sample_plain
from combo_avs_torch.ops.lsap import solve_lsap_batch
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401 (autouse fixtures)


def test_kernel_takes():
    """The dispatch rule over device, K and map size, in one test: the dtype
    does not route (on the card both routes take float32 only)."""
    cases = [  # device, mask h x w, K, whether the kernel takes it
        ("cuda", (56, 56), 3, True),  # S4 and MS3 training, fp32 and AMP alike
        ("cuda", (56, 56), 1, True),  # fewer slots than the 3 the accumulators hold
        ("cuda", (56, 56), 12, True),  # AVSS's 12 slots
        ("cuda", (56, 56), 16, True),  # MAX_K
        ("cuda", (56, 56), 17, False),
        ("cuda", (56, 56), 0, False),
        ("cpu", (56, 56), 3, False),
        ("cuda", (59, 60), 3, True),  # 8 maps of 14160 bytes fill STAGE_BYTES
        ("cuda", (60, 60), 3, False),  # one float over
        ("cuda", (96, 96), 12, True),  # 2 maps a block at K > 3
    ]
    got = [match_cost_cuda.kernel_takes(device, hw, K) for device, hw, K, _ in cases]
    assert got == [takes for *_, takes in cases]


def test_launch_plan():
    """The plan at the training cells', AVSS's and two tiny shapes, in one test."""
    cases = [  # N, Q, H, W, K, then the plan's slots, queries, chunks, shared bytes
        (40, 100, 56, 56, 3, 3, 8, 13, 100352),  # the training cells' shape
        (80, 100, 56, 56, 12, 16, 2, 50, 25088),  # AVSS
        (3, 13, 7, 5, 1, 3, 8, 2, 4 * 9 * 83),  # tiny maps: the reduction's floats set the size
        (2, 9, 8, 8, 5, 16, 2, 5, 4 * 9 * 114),
    ]
    for N, Q, H, W, K, kc, qb, chunks, smem in cases:
        plan = match_cost_cuda.launch_plan(N, Q, H, W, K)
        assert plan == (kc, qb, chunks, N * chunks, smem)
        assert list(match_cost_cuda.plan_args(N, Q, H, W, 12544, K, 2, plan)) == [
            N, Q, H, W, 12544, K, 2, kc, qb, chunks, smem]
        assert plan.chunks * qb >= Q > (plan.chunks - 1) * qb


def test_argtypes_match_the_c_signature():
    """ctypes passes exactly the C function's arguments (a float passed as an
    int would reach the kernel as garbage; the kernel cannot run here)."""
    from tests.test_torch_point_sample import c_signature

    assert match_cost_cuda.ARGTYPES == c_signature(match_cost_cuda.SOURCE, "match_cost")


def _layers(n_layers=2, N=2, Q=5, h=8, K=2, P=64, C1=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    tgt = torch.rand((N, K, 4 * h, 4 * h), generator=g) > 0.5
    labels = torch.randint(0, C1, (N, K), generator=g)
    valid = torch.tensor([[True, False], [True, True]])[:, :K]
    return [(torch.rand((N, P, 2), generator=g), torch.randn((N, Q, C1), generator=g),
             4 * torch.randn((N, Q, h, h), generator=g), labels, tgt, valid)
            for _ in range(n_layers)]


def test_cpu_runs_the_composition(monkeypatch):
    """On the CPU every call is the plain composition with nan_to_num, and
    nothing is built or launched."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the CUDA build or the kernel")

    monkeypatch.setattr(_build, "load_all", refuse)
    monkeypatch.setattr(match_cost_cuda, "match_cost_cuda", refuse)
    layers = _layers()
    layers[1][2][0, 1] = float("nan")  # a NaN map: its query costs BIG_COST
    m = HungarianMatcher(num_points=64)
    costs = m.solved_costs(layers)
    for got, args in zip(costs, layers):
        want = torch.nan_to_num(m.cost_matrix(*args), nan=BIG_COST, posinf=BIG_COST,
                                neginf=-BIG_COST)
        assert torch.equal(got, want)
    assert (costs[1][0, 1] == BIG_COST).all() and (costs[0][:, :, 1][0] == BIG_COST).all()
    assign = m.match_layers(layers)
    solved = solve_lsap_batch(torch.cat(costs).transpose(1, 2)).split([2, 2])
    for a, s, args in zip(assign, solved, layers):
        assert torch.equal(a, torch.where(args[5], s, -1))


def test_kernel_route(monkeypatch):
    """Where kernel_takes says yes, each decoder output is one kernel call
    with its masks as they are and the target masks sampled at its points
    from one [N, H, W, K] float32 copy shared by every output."""
    calls, copies = [], []
    real_nhwc = _targets_nhwc

    def kernel(points, logits, masks, tgt_points, labels, valid, weights):
        calls.append((points, logits, masks, tgt_points, labels, valid, weights))
        return torch.zeros((masks.shape[0], masks.shape[1], labels.shape[1]))

    def nhwc(t):
        copies.append(t)
        return real_nhwc(t)

    monkeypatch.setattr(match_cost_cuda, "kernel_takes", lambda *a: True)
    monkeypatch.setattr(match_cost_cuda, "match_cost_cuda", kernel)
    monkeypatch.setattr("combo_avs_torch.losses.matcher._targets_nhwc", nhwc)
    layers = _layers(n_layers=3)
    HungarianMatcher(cost_class=1.0, cost_mask=2.0, cost_dice=3.0).match_layers(layers)
    assert len(calls) == 3 and len(copies) == 1
    for (points, logits, masks, tgt_points, labels, valid, weights), args in zip(calls, layers):
        assert points is args[0] and logits is args[1] and masks is args[2]
        assert labels is args[3] and valid is args[5] and weights == (1.0, 2.0, 3.0)
        want = point_sample_plain(args[4].permute(0, 2, 3, 1).float(), args[0])
        assert tgt_points.dtype == torch.float32 and torch.equal(tgt_points, want)
