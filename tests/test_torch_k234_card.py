"""The hand-written CUDA kernels of the training slice against their plain
PyTorch versions, on a CUDA card: K2 (the deformable-attention backward,
through `MSDeformAttnFunction`, in fp32 and in the AMP step's bf16), K3/K5 (the point-sample forward) and K4 (its
image and point gradients, through `PointSampleFunction`). The kernels have
no CPU mode, so without a card every test here skips.

This file imports neither jax nor the JAX package, so it runs on a machine
with only torch. Skip tests/conftest.py, which configures jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k234_card.py
"""

import contextlib
from unittest import mock

import pytest
import torch

from chip_smoke import K2_TOL_BF16, TOL_FP32, k1_inputs, misaligned, point_inputs
from combo_avs_torch.ops import deform_attn_cuda, point_sample_cuda
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain
from combo_avs_torch.ops.grid_sample import point_sample, point_sample_plain

LEVELS = ((7, 7), (14, 14), (28, 28))  # the main path's levels at 224^2
DEFORM = {"main": dict(levels=LEVELS, lq=1029, m=8, d=32, b=2),
          "ragged": dict(levels=((3, 5), (6, 10)), lq=37, m=3, d=16, b=3)}
POINTS = {  # feat [N, H, W, C] at P points
    "criterion": (6, 56, 56, 1, 12544),
    "labels": (3, 224, 224, 1, 2000),
    "matcher": (2, 56, 56, 100, 12544),
    "ragged": (3, 7, 5, 33, 101),
    # the forward's launch-plan edges (ops/point_sample_cuda.py::launch_plan)
    "c3_p_odd": (3, 56, 56, 3, 12545),  # staged, scalar tail path
    "c4_staged": (3, 32, 32, 4, 1003),
    "c4_global": (2, 56, 56, 4, 1000),  # 50176 bytes: the channels kernel
    "c2_vec": (3, 56, 56, 2, 1030),  # vector path, the last 2 points scalar
    "c3_labels": (2, 224, 224, 3, 999),
    "at_stage_limit": (2, 64, 64, 3, 4096),  # 49152 bytes, staged
    "one_over_stage_limit": (2, 1, 12289, 1, 3001),
    "channels_vec": (2, 56, 56, 8, 777),
    "many_images": (70000, 2, 2, 1, 6),  # more images than grid rows
}
DIMG = {  # N, H, W, C, P, inputs misaligned, the kernel the plan chooses on an H100 (132
    # SMs): the image gradient at its launch plan's edges
    "train": (120, 56, 56, 1, 12544, False, "staged"),  # the criterion's: 2 blocks an image
    "c4_staged": (16, 32, 32, 4, 1003, False, "staged"),
    "c3_odd_p": (16, 56, 56, 3, 12545, False, "staged"),  # scalar tail path
    "misaligned": (16, 56, 56, 1, 2048, True, "staged"),  # points and gradients 4 bytes off
    "eight_images": (8, 56, 56, 1, 12544, False, "staged"),  # 4 blocks an image
    "seven_images": (7, 56, 56, 1, 12544, False, "global"),  # too few to fill the card
    "one_image": (1, 56, 56, 1, 12544, False, "global"),
    "many_images": (300, 56, 56, 1, 2000, False, "staged"),  # more images than SMs
    "few_points": (16, 56, 56, 1, 5, False, "staged"),
    "ragged": (3, 7, 5, 33, 101, False, "global"),  # C > 4: global only
}
MISALIGNED = {  # inputs one float off their allocation's 16-byte alignment
    "c1_staged": (4, 56, 56, 1, 2048),
    "c4_global": (2, 56, 56, 4, 1000),
    "c3_labels": (2, 224, 224, 3, 999),
    "channels": (2, 56, 56, 100, 300),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2-K5 are CUDA kernels with no CPU mode)")
    return torch.device("cuda", 0)


def _close(got, want, tol=TOL_FP32):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def _plain_grads(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, g)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["level_slice", "global"])
@pytest.mark.parametrize("case", sorted(DEFORM))
def test_k2_matches_plain_autograd(cuda_device, case, plan):
    """dvalue, dlocations and dweights through the autograd Function (K1
    forward, K2 backward) against autograd of the plain version, under each
    of K2's launch plans: the level-slice kernel, which bwd_launch_plan
    picks for these shapes, and the global one, which it picks on a card
    that offers no opt-in shared memory (an opt-in limit of 0)."""
    c = DEFORM[case]
    assert deform_attn_cuda.bwd_launch_plan(c["levels"], c["lq"], c["m"], c["d"], 4,
                                            deform_attn_cuda.smem_optin(0)).kernel == "level_slice"
    value, loc, w = k1_inputs(c["b"], c["m"], c["d"], 4, c["levels"], c["lq"], torch.float32,
                              cuda_device, seed=5)
    g = torch.randn((c["b"], c["lq"], c["m"] * c["d"]), device=cuda_device)
    before = (deform_attn_cuda.launches, deform_attn_cuda.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
    optin = (contextlib.nullcontext() if plan == "level_slice"
             else mock.patch.object(deform_attn_cuda, "smem_optin", lambda index: 0))
    with optin:
        out = deform_attn_cuda.ms_deform_attn(leaves[0], c["levels"], leaves[1], leaves[2])
        got = torch.autograd.grad(out, leaves, g)
    assert (deform_attn_cuda.launches, deform_attn_cuda.bwd_launches) == (before[0] + 1,
                                                                          before[1] + 1)
    want = _plain_grads(lambda v, l, a: ms_deform_attn_plain(v, c["levels"], l, a),
                        (value, loc, w), g)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["level_slice", "global"])
@pytest.mark.parametrize("case", sorted(DEFORM))
def test_k2_bf16_matches_plain_autograd(cuda_device, case, plan):
    """The bf16 AMP step's K2: a bf16 value, gradient, locations and weights
    through the autograd Function under each launch plan, against the plain
    version's fp32 autograd on the same bf16-rounded inputs, each gradient
    rounded to bf16 (one bf16 ulp apart at most: K2_TOL_BF16 of max |plain|);
    the gradients come back in bf16, as the inputs are."""
    c = DEFORM[case]
    value, loc, w = (t.bfloat16() for t in k1_inputs(
        c["b"], c["m"], c["d"], 4, c["levels"], c["lq"], torch.float32, cuda_device, seed=7))
    g = torch.randn((c["b"], c["lq"], c["m"] * c["d"]), device=cuda_device).bfloat16()
    before = dict(deform_attn_cuda.bwd_dtype_launches)
    leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
    optin = (contextlib.nullcontext() if plan == "level_slice"
             else mock.patch.object(deform_attn_cuda, "smem_optin", lambda index: 0))
    with optin:
        out = deform_attn_cuda.ms_deform_attn(leaves[0], c["levels"], leaves[1], leaves[2])
        got = torch.autograd.grad(out, leaves, g)
    assert deform_attn_cuda.bwd_dtype_launches == dict(before, bfloat16=before["bfloat16"] + 1)
    want = _plain_grads(lambda v, l, a: ms_deform_attn_plain(v, c["levels"], l, a),
                        (value.float(), loc.float(), w.float()), g.float())
    for a, b in zip(got, want):
        _close(a, b.bfloat16(), tol=K2_TOL_BF16)


@pytest.mark.gpu
def test_k2_refuses_what_it_does_not_take(cuda_device):
    c = DEFORM["ragged"]
    value, loc, w = k1_inputs(1, c["m"], c["d"], 4, c["levels"], 5, torch.float32, cuda_device,
                              seed=6)
    g = torch.ones((1, 5, c["m"] * c["d"]), device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        deform_attn_cuda.ms_deform_attn_bwd_cuda(value.half(), c["levels"], loc, w, g)
    with pytest.raises(ValueError, match="grad_out"):
        deform_attn_cuda.ms_deform_attn_bwd_cuda(value, c["levels"], loc, w, g[:, :4])
    with pytest.raises(ValueError, match="CUDA"):
        deform_attn_cuda.ms_deform_attn_bwd_cuda(value.cpu(), c["levels"], loc.cpu(), w.cpu(),
                                                 g.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(POINTS))
def test_point_sample_matches_plain(cuda_device, case):
    """K3/K5 forward, and K4's image and point gradients through the autograd
    Function, against the plain version and its autograd."""
    n, h, w, c, p = POINTS[case]
    feat, pts = point_inputs(n, h, w, c, p, cuda_device, seed=7)
    g = torch.randn((n, p, c), device=cuda_device)
    before = (point_sample_cuda.fwd_launches, point_sample_cuda.dimg_launches,
              point_sample_cuda.dxy_launches)
    f_, p_ = feat.clone().requires_grad_(), pts.clone().requires_grad_()
    out = point_sample(f_, p_)
    got_df, got_dp = torch.autograd.grad(out, (f_, p_), g)
    assert (point_sample_cuda.fwd_launches, point_sample_cuda.dimg_launches,
            point_sample_cuda.dxy_launches) == tuple(x + 1 for x in before)
    _close(out.detach(), point_sample_plain(feat, pts))
    want_df, want_dp = _plain_grads(point_sample_plain, (feat, pts), g)
    _close(got_df, want_df)
    _close(got_dp, want_dp)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MISALIGNED))
@pytest.mark.parametrize("which", ["feat", "points", "both"])
def test_point_sample_fwdmisaligned(cuda_device, case, which):
    """Inputs off the 16-byte alignment take the plan's tail-safe path and
    give the aligned inputs' result, bit for bit."""
    n, h, w, c, p = MISALIGNED[case]
    feat, pts = point_inputs(n, h, w, c, p, cuda_device, seed=10)
    f = misaligned(feat) if which in ("feat", "both") else feat
    q = misaligned(pts) if which in ("points", "both") else pts
    assert f.is_contiguous() and q.is_contiguous()
    plan = point_sample_cuda.launch_plan(n, h, w, c, p, f.data_ptr(), q.data_ptr())
    if which != "feat" and plan.kernel == "staged":  # no float4 point loads
        assert not plan.vec
    if which != "points" and plan.kernel == "channels":  # no float4 channel units
        assert not plan.vec
    if which != "points" and plan.kernel == "staged":  # the copy goes 4 bytes at a time
        assert not plan.stage16
    got = point_sample_cuda.point_sample_fwd_cuda(f, q)
    want = point_sample_cuda.point_sample_fwd_cuda(feat, pts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close(got, point_sample_plain(feat, pts))


def _dimg_plan(n, h, w, c, p, pts, g, optin=None, sms=None):
    return point_sample_cuda.dimg_launch_plan(
        n, h, w, c, p, pts.data_ptr(), g.data_ptr(),
        point_sample_cuda.sm_count(0) if sms is None else sms,
        point_sample_cuda.smem_optin(0) if optin is None else optin)


@pytest.mark.gpu
@pytest.mark.parametrize("plan,case", [
    *((plan, case) for case in sorted(DIMG) for plan in ("chosen", "global")),
    # staged forced where the plan takes global for too few images
    *(("staged", case) for case in sorted(DIMG) if DIMG[case][3] <= 4
      and DIMG[case][6] == "global")])
def test_dimg_plans_match_plain_autograd(cuda_device, case, plan):
    """The image gradient under the plan's own choice, forced through the
    global kernel (the plan at an opt-in limit of 0) and, below the images
    that fill the card, forced through the staged one (the plan for a card
    of one SM), against autograd of the plain version; each launch counted
    under its plan."""
    n, h, w, c, p, misalign, chosen = DIMG[case]
    feat, pts = point_inputs(n, h, w, c, p, cuda_device, seed=11)
    g = torch.randn((n, p, c), device=cuda_device)
    want = _plain_grads(point_sample_plain, (feat, pts), g)[0]
    if misalign:
        pts, g = misaligned(pts), misaligned(g)
    forced = {"chosen": None, "global": lambda: _dimg_plan(n, h, w, c, p, pts, g, optin=0),
              "staged": lambda: _dimg_plan(n, h, w, c, p, pts, g, sms=1)}[plan]
    forced = forced and forced()
    kernel = (forced or _dimg_plan(n, h, w, c, p, pts, g)).kernel
    assert kernel == (chosen if plan == "chosen" else plan)
    before = dict(point_sample_cuda.dimg_plan_launches)
    got = point_sample_cuda.point_sample_dimg_cuda(pts, g, (h, w), plan=forced)
    assert point_sample_cuda.dimg_plan_launches[kernel] == before[kernel] + 1
    _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("extra,kernel", [(0, "staged"), (1, "global")])
def test_dimg_at_the_shared_memory_limit(cuda_device, extra, kernel):
    """An image whose shared memory fills the card's opt-in limit exactly is
    staged; one element more takes the global kernel; both agree with the
    plain version."""
    optin = point_sample_cuda.smem_optin(0)
    width = max(w for w in range(optin // 4 - 4, optin // 4 + 1)
                if point_sample_cuda.dimg_smem_bytes(1, w, 1) <= optin) + extra
    feat, pts = point_inputs(16, 1, width, 1, 3001, cuda_device, seed=12)
    g = torch.randn((16, 3001, 1), device=cuda_device)
    assert _dimg_plan(16, 1, width, 1, 3001, pts, g).kernel == kernel
    _close(point_sample_cuda.point_sample_dimg_cuda(pts, g, (1, width)),
           _plain_grads(point_sample_plain, (feat, pts), g)[0])


@pytest.mark.gpu
def test_dimg_staged_with_an_inf_gradient(cuda_device):
    """A gradient holding an inf gives inf at the point's four corners, as
    the plain version does; the other images and elements agree with it."""
    feat, pts = point_inputs(16, 56, 56, 1, 2048, cuda_device, seed=14)
    pts[1, 7] = torch.tensor([10.3 / 56, 20.3 / 56], device=cuda_device)
    g = torch.randn((16, 2048, 1), device=cuda_device)
    assert _dimg_plan(16, 56, 56, 1, 2048, pts, g).kernel == "staged"
    g[1, 7, 0] = float("inf")
    want = _plain_grads(point_sample_plain, (feat, pts), g)[0]
    got = point_sample_cuda.point_sample_dimg_cuda(pts, g, (56, 56))
    finite = torch.isfinite(want)
    assert int((~finite).sum()) == 4 and torch.equal(torch.isfinite(got), finite)
    _close(got[finite], want[finite])


@pytest.mark.gpu
def test_point_gradient_kernel_runs_only_when_points_need_it(cuda_device):
    """On the training path the points carry no gradient: the backward then
    launches the image-gradient kernel alone."""
    feat, pts = point_inputs(2, 56, 56, 1, 500, cuda_device, seed=8)
    before = (point_sample_cuda.dimg_launches, point_sample_cuda.dxy_launches)
    f_ = feat.clone().requires_grad_()
    point_sample(f_, pts).sum().backward()
    assert (point_sample_cuda.dimg_launches, point_sample_cuda.dxy_launches) == (
        before[0] + 1, before[1])


@pytest.mark.gpu
def test_point_sample_refuses_what_it_does_not_take(cuda_device):
    feat, pts = point_inputs(2, 8, 8, 3, 10, cuda_device, seed=9)
    with pytest.raises(TypeError, match="float32"):
        point_sample_cuda.point_sample_fwd_cuda(feat.double(), pts.double())
    with pytest.raises(ValueError, match="contiguous"):
        point_sample_cuda.point_sample_fwd_cuda(feat[..., ::2], pts)
    with pytest.raises(ValueError, match="N, H, W, C"):
        point_sample_cuda.point_sample_fwd_cuda(feat[:1], pts)
    with pytest.raises(ValueError, match=r"\[N, P, 2\]"):
        point_sample_cuda.point_sample_fwd_cuda(feat, pts[..., :1].contiguous())
