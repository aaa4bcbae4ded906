"""The fused matcher-cost kernel (`csrc/match_cost.cu`) against the plain
composition (`HungarianMatcher.cost_matrix`, then `nan_to_num`), on a CUDA
card: at the training cells' shape, at AVSS's 12 slots and 72 classes, and
at ragged edges; and the LSAP assignments the two give. The kernel has no
CPU mode, so without a card every test here skips.

Tolerance (`chip_smoke.MATCH_COST_RTOL`): both sides sum the same fp32
terms over P points in another order (the kernel: a lane's points in turn,
then a warp's and the block's trees; the composition: cuBLAS's batched
products), and take exp, log1p and the reciprocal through other code. A
sum's rounding is a few times sqrt(P) x 2^-24 of its magnitude on either
side; the costs lie in [0, about 12] (class up to 2, CE and dice up to 5
each at the S4 weights), so the kernel is held to 3e-5 of the largest valid
cost, which a wrong term (a missing +1, another label, a dropped point)
exceeds by orders of magnitude. Invalid slots and NaN costs are BIG_COST on
both sides exactly.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_matchcost_card.py
"""

import os
import subprocess
import sys

import pytest
import torch

from chip_smoke import compare_costs, matcher_inputs
from combo_avs_torch.losses.matcher import BIG_COST, HungarianMatcher, _targets_nhwc
from combo_avs_torch.ops import match_cost_cuda
from combo_avs_torch.ops.grid_sample import point_sample
from combo_avs_torch.ops.lsap import solve_lsap_batch

CASES = {  # N frames, Q queries, mask h x w, P points, K slots, C + 1 classes, point spread
    "cells": (40, 100, (56, 56), 12544, 3, 2, "uniform"),  # both training cells
    "avss": (8, 100, (56, 56), 12544, 12, 72, "uniform"),  # AVSS's slots and classes
    "ragged": (3, 13, (7, 5), 1001, 1, 3, "border"),  # Q, P off the chunk and stride; K = 1
    "k16": (2, 20, (16, 12), 777, 16, 5, "border"),  # MAX_K
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the matcher-cost kernel has no CPU mode)")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def composition(matcher, args):
    return torch.nan_to_num(matcher.cost_matrix(*args), nan=BIG_COST, posinf=BIG_COST,
                            neginf=-BIG_COST)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_composition(cuda_device, case):
    N, Q, hw, P, K, C1, spread = CASES[case]
    args = matcher_inputs(N, Q, hw, P, K, C1, spread, cuda_device, seed=len(case))
    if case == "ragged":
        args[2][1, 2] = float("nan")  # a NaN map: that query's costs are BIG_COST
    matcher = HungarianMatcher()
    assert match_cost_cuda.kernel_takes("cuda", hw, K)
    before = match_cost_cuda.launches
    got = matcher.solved_costs([args])[0]
    assert match_cost_cuda.launches == before + 1
    want = composition(matcher, args)
    compare_costs(f"[match_cost] {case}", got, want, args[5])
    if case == "ragged":
        assert (got[1, 2] == BIG_COST).all()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_same_assignments_at_the_cells_shape(cuda_device, seed):
    """Three decoder outputs through match_layers: the kernel's costs give the
    composition's LSAP assignments."""
    N, Q, hw, P, K, C1, spread = CASES["cells"]
    layers = [matcher_inputs(N, Q, hw, P, K, C1, spread, cuda_device, seed=100 * seed + i)
              for i in range(3)]
    matcher = HungarianMatcher()
    before = match_cost_cuda.launches
    got = matcher.match_layers(layers)
    assert match_cost_cuda.launches == before + 3
    want = solve_lsap_batch(torch.cat([composition(matcher, a) for a in layers]).transpose(1, 2))
    for g, w, args in zip(got, want.split(N), layers):
        assert torch.equal(g, torch.where(args[5], w, -1))


@pytest.mark.gpu
def test_refusals(cuda_device):
    """The wrapper raises on what the kernel does not take; no fallback."""
    N, Q, hw, P, K, C1, spread = CASES["ragged"]
    points, logits, masks, labels, tgt, valid = matcher_inputs(N, Q, hw, P, K, C1, spread,
                                                               cuda_device, seed=5)
    tgt_points = point_sample(_targets_nhwc(tgt), points)
    with pytest.raises(TypeError):
        match_cost_cuda.match_cost_cuda(points, logits, masks.bfloat16(), tgt_points, labels,
                                        valid, (2.0, 5.0, 5.0))
    with pytest.raises(ValueError):
        match_cost_cuda.match_cost_cuda(points.cpu(), logits, masks, tgt_points, labels, valid,
                                        (2.0, 5.0, 5.0))
    with pytest.raises(ValueError):
        match_cost_cuda.match_cost_cuda(points, logits, masks, tgt_points[:, :-1], labels,
                                        valid, (2.0, 5.0, 5.0))


@pytest.mark.gpu
def test_label_out_of_range_stops_the_kernel(cuda_device):
    """A label past the last class stops the kernel, as torch.gather's device
    assert stops the composition; it is not clamped into range. The error
    leaves the CUDA context unusable, so it runs in a process of its own."""
    code = (
        "import torch\n"
        "from chip_smoke import matcher_inputs\n"
        "from combo_avs_torch.losses.matcher import HungarianMatcher\n"
        "args = list(matcher_inputs(2, 9, (8, 8), 300, 3, 4, 'border', "
        "torch.device('cuda', 0), seed=7))\n"
        "args[3][1, 2] = 4  # one past the last of C + 1 = 4 classes\n"
        "HungarianMatcher().solved_costs([args])\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode != 0 and "no error" not in run.stdout, run.stdout + run.stderr
