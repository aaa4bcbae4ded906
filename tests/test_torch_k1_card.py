"""The hand-written CUDA kernel K1 (multi-scale deformable attention forward)
against its plain PyTorch version, on a CUDA card, under both of
`fwd_launch_plan`'s plans. K1 has no CPU mode, so without a card every test
here skips.

This file imports neither jax nor the JAX package, so it runs on a machine
with only torch. Skip tests/conftest.py, which configures jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k1_card.py
"""

import pytest
import torch

from chip_smoke import K1_TOL_BF16, K1_TOL_FP32, k1_inputs
from combo_avs_torch.ops import deform_attn_cuda
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

MAIN = dict(levels=((7, 7), (14, 14), (28, 28)), lq=1029, m=8, d=32)  # the main path's shape
RAGGED = dict(levels=((3, 5), (6, 10)), lq=37, m=3, d=16)  # D=16, Lq*M not a multiple of 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel with no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["staged", "global"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, K1_TOL_FP32), (torch.bfloat16, K1_TOL_BF16)])
@pytest.mark.parametrize("shape", [MAIN, RAGGED], ids=["main", "ragged"])
def test_k1_matches_plain(cuda_device, dtype, tol, shape, kernel):
    # fp32: another summation order (1e-5 of max|out|); bf16: both sides round
    # the fp32 sum to bf16 once, so one ulp (2^-8 relative) of max|out|
    levels = shape["levels"]
    value, loc, w = k1_inputs(2, shape["m"], shape["d"], 4, levels, shape["lq"], dtype,
                              cuda_device, seed=3)
    # the card's limit gives the staged plan at these shapes, a limit of 0 the global one
    limit = deform_attn_cuda.smem_optin(cuda_device.index) if kernel == "staged" else 0
    plan = deform_attn_cuda.fwd_launch_plan(levels, 2, shape["lq"], shape["m"], shape["d"], 4,
                                            value.element_size(), limit,
                                            deform_attn_cuda.sm_count(cuda_device.index))
    assert plan.kernel == kernel
    before = dict(deform_attn_cuda.fwd_plan_launches, all=deform_attn_cuda.launches)
    with torch.inference_mode():
        got = deform_attn_cuda.ms_deform_attn_cuda(value, levels, loc, w, plan=plan)
        want = ms_deform_attn_plain(value, levels, loc, w)
    torch.cuda.synchronize()
    assert deform_attn_cuda.launches == before["all"] + 1
    assert deform_attn_cuda.fwd_plan_launches[kernel] == before[kernel] + 1
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.gpu
def test_k1_dispatch_takes_the_plan(cuda_device):
    """The dispatch launches fwd_launch_plan's choice: staged at the main
    shape on a card whose opt-in limit holds the slice."""
    levels = MAIN["levels"]
    value, loc, w = k1_inputs(1, 8, 32, 4, levels, 1029, torch.float32, cuda_device, seed=6)
    chosen = deform_attn_cuda.fwd_launch_plan(levels, 1, 1029, 8, 32, 4, 4,
                                              deform_attn_cuda.smem_optin(cuda_device.index),
                                              deform_attn_cuda.sm_count(cuda_device.index))
    before = dict(deform_attn_cuda.fwd_plan_launches)
    with torch.inference_mode():
        deform_attn_cuda.ms_deform_attn(value, levels, loc, w)
    torch.cuda.synchronize()
    assert chosen.kernel == "staged"
    assert deform_attn_cuda.fwd_plan_launches[chosen.kernel] == before[chosen.kernel] + 1


@pytest.mark.gpu
def test_k1_forced_plan_over_the_limit_raises(cuda_device):
    """A staged plan whose shared memory exceeds the card's opt-in limit (a
    48^2 level's slice in fp32, 387 KB) is refused by the launch, which
    raises; nothing falls back to another kernel."""
    levels = ((48, 48), (24, 24), (12, 12))
    value, loc, w = k1_inputs(1, 2, 32, 4, levels, 5, torch.float32, cuda_device, seed=7)
    optin = deform_attn_cuda.smem_optin(cuda_device.index)
    sms = deform_attn_cuda.sm_count(cuda_device.index)
    assert deform_attn_cuda.fwd_launch_plan(levels, 1, 5, 2, 32, 4, 4, optin,
                                            sms).kernel == "global"
    plan = deform_attn_cuda.fwd_launch_plan(levels, 1, 5, 2, 32, 4, 4, 10**7, sms)
    assert plan.kernel == "staged"
    assert plan.smem_bytes > optin
    before = deform_attn_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        deform_attn_cuda.ms_deform_attn_cuda(value, levels, loc, w, plan=plan)
    assert deform_attn_cuda.launches == before


@pytest.mark.gpu
def test_k1_refuses_what_it_does_not_take(cuda_device):
    value, loc, w = k1_inputs(1, 2, 8, 4, RAGGED["levels"], 5, torch.float32, cuda_device, seed=4)
    with pytest.raises(TypeError):
        deform_attn_cuda.ms_deform_attn_cuda(value.half(), RAGGED["levels"], loc, w)
    with pytest.raises(ValueError, match="sum of spatial shapes"):
        deform_attn_cuda.ms_deform_attn_cuda(value, ((3, 5), (6, 9)), loc, w)
    with pytest.raises(ValueError, match="contiguous"):
        deform_attn_cuda.ms_deform_attn_cuda(value[..., ::2], RAGGED["levels"], loc, w)
    # the autograd Function takes what both kernels take (K2 reads fp32 and bf16 too)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        deform_attn_cuda.ms_deform_attn(value.half().requires_grad_(), RAGGED["levels"], loc, w)
