"""The hand-written CUDA kernels of the eval tail and the criterion's
fallback against their plain PyTorch versions, on a CUDA card: K7 (fused
semantic inference, `ops/seminf_cuda.py`) and K6 (row gather,
`ops/gather_cuda.py`). The kernels have no CPU mode, so without a card every
test here skips.

This file imports neither jax nor the JAX package, so it runs on a machine
with only torch. Skip tests/conftest.py, which configures jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k67_card.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import K7_TOL_BF16, TOL_FP32, seminf_inputs
from combo_avs_torch.losses.criterion import uncertainty_sampled_points
from combo_avs_torch.models.meta_arch import semantic_inference
from combo_avs_torch.ops import gather_cuda, seminf_cuda

SEMINF = {  # N, Q, C, h, w, H, W
    "s4": (4, 100, 2, 56, 56, 224, 224),  # patch 4 x 4
    "ragged": (3, 7, 5, 5, 9, 13, 31),  # H*W not a multiple of the block; pixel only
    "same_size": (2, 3, 8, 6, 6, 6, 6),  # a ratio of 1: pixel
    "one_class": (2, 4, 1, 3, 4, 9, 4),  # ratios 3 and 1: pixel
    "x3x2": (2, 4, 1, 3, 4, 9, 8),  # patch 2 x 2
    "x3": (2, 100, 2, 56, 56, 168, 168),  # patch 2 x 2, the last patch of a band cut
    "x2x8_c5": (3, 9, 5, 7, 6, 14, 48),  # C > 4: 2 x 2
    "x8_c8": (2, 5, 8, 4, 4, 32, 32),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 and K7 are CUDA kernels with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["chosen", "pixel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(SEMINF))
def test_k7_matches_plain(cuda_device, case, dtype, plan):
    """K7 under the plan's own choice (patch at integer ratios of at least
    2, else pixel)
    and forced through the pixel kernel, with the temporal mask off and on;
    each launch counted under its plan."""
    N, Q, C, h, w, H, W = SEMINF[case]
    cls, mask, tm = seminf_inputs(N, Q, C, h, w, dtype, cuda_device, seed=3)
    forced = seminf_cuda.pixel_plan(Q, C, H, W) if plan == "pixel" else None
    kernel = (forced or seminf_cuda.launch_plan(N, Q, C, h, w, H, W)).kernel
    integer = H % h == 0 and W % w == 0 and min(H // h, W // w) >= 2
    assert kernel == ("patch" if plan == "chosen" and integer else "pixel")
    for temporal in (None, tm):
        before = (seminf_cuda.launches, seminf_cuda.plan_launches[kernel])
        got = seminf_cuda.seminf_cuda(cls, mask, (H, W), temporal, plan=forced)
        assert (seminf_cuda.launches, seminf_cuda.plan_launches[kernel]) == (before[0] + 1,
                                                                            before[1] + 1)
        want = seminf_cuda.semantic_inference_plain(cls, mask, (H, W), temporal)
        _close(got, want, TOL_FP32 if dtype == torch.float32 else K7_TOL_BF16)


@pytest.mark.gpu
def test_semantic_inference_dispatch(cuda_device):
    """meta_arch.semantic_inference launches K7 for C <= 8 and an upsampling
    size, and takes the plain version for many classes or a downsampling."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    logits = lambda c: torch.randn((2, 6, c + 1), generator=g, device=cuda_device)  # noqa: E731
    mask = torch.randn((2, 6, 8, 8), generator=g, device=cuda_device)
    for c, size, fused in ((2, (32, 32), True), (71, (32, 32), False), (2, (4, 4), False)):
        before = seminf_cuda.launches
        out = semantic_inference(logits(c), mask, size)
        assert out.shape == (2, c, *size) and out.dtype == torch.float32
        assert seminf_cuda.launches == before + int(fused)


@pytest.mark.gpu
def test_k7_refuses_what_it_does_not_take(cuda_device):
    cls, mask, _ = seminf_inputs(2, 3, 2, 4, 4, torch.float32, cuda_device, seed=4)
    with pytest.raises(ValueError, match="upsampling"):
        seminf_cuda.seminf_cuda(cls, mask, (2, 2))
    with pytest.raises(ValueError, match="C <= 8"):
        seminf_cuda.seminf_cuda(torch.rand((2, 3, 9), device=cuda_device), mask, (8, 8))
    with pytest.raises(TypeError, match="bfloat16"):
        seminf_cuda.seminf_cuda(cls, mask.double(), (8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        seminf_cuda.seminf_cuda(cls.cpu(), mask.cpu(), (8, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("shape", [(120, 37632, 9408), (240, 37632, 9408), (3, 1500, 1001),
                                   (3, 17, 1000), (5, 1, 3)])
def test_k6_matches_gather(cuda_device, shape, index_dtype):
    """Exact equality with torch.gather, the edge indices 0 and NS - 1
    included, at the criterion's shape and at a P that is not a multiple of
    the block."""
    G, NS, P = shape
    g = torch.Generator(device=cuda_device).manual_seed(G)
    src = torch.randn((G, NS, 2), generator=g, device=cuda_device)
    idx = torch.randint(0, NS, (G, P), generator=g, device=cuda_device)
    idx[:, 0], idx[:, -1] = 0, NS - 1
    idx = idx.to(index_dtype)
    before = gather_cuda.launches
    got = gather_cuda.gather_points(src, idx)
    assert gather_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
def test_k6_every_plan_matches_gather(cuda_device, index_dtype):
    """Both of the kernel's widths (4 points a thread on an aligned index,
    1 on an index 8 bytes past a 16-byte boundary) equal torch.gather at a
    ragged shape (3 x 1001 points, no multiple of 4), and the floors launch
    on the gather's grid."""
    G, NS, P = 3, 1500, 1001
    g = torch.Generator(device=cuda_device).manual_seed(5)
    src = torch.randn((G, NS, 2), generator=g, device=cuda_device)
    idx = torch.randint(0, NS, (G, P), generator=g, device=cuda_device).to(index_dtype)
    want = gather_cuda.gather_points_plain(src, idx)
    step = 8 // idx.element_size()
    off = torch.empty(G * P + step, dtype=index_dtype, device=cuda_device)[step:].view(G, P)
    off.copy_(idx)
    for index, vec in ((idx, 4), (off, 1)):
        assert gather_cuda.points_per_thread(index.element_size(), index.data_ptr(),
                                             want.data_ptr()) == vec
        assert torch.equal(gather_cuda.gather_points_cuda(src, index), want), vec
    before = gather_cuda.launches
    copied = gather_cuda.gather_floor_cuda(src, idx, "stream")
    gather_cuda.gather_floor_cuda(src, idx, "empty")
    torch.cuda.synchronize()
    assert gather_cuda.launches == before  # the floors are not the gather
    bits = copied.view(torch.int64 if index_dtype == torch.int64 else torch.int32)
    assert torch.equal(bits.reshape(G, P, -1)[..., 0], idx)


@pytest.mark.gpu
def test_k6_misaligned_index_takes_one_point_a_thread(cuda_device):
    """An index view 8 bytes past an aligned address cannot take 16-byte
    loads: the plan takes one point a thread, and the gather is still
    exact."""
    G, NS, P = 4, 300, 257
    g = torch.Generator(device=cuda_device).manual_seed(6)
    src = torch.randn((G, NS, 2), generator=g, device=cuda_device)
    idx = torch.randint(0, NS, (G * P + 1,), generator=g, device=cuda_device)[1:].view(G, P)
    assert idx.data_ptr() % 16 == 8
    out = torch.empty((G, P, 2), device=cuda_device)
    assert gather_cuda.points_per_thread(8, idx.data_ptr(), out.data_ptr()) == 1
    assert torch.equal(gather_cuda.gather_points(src, idx),
                       gather_cuda.gather_points_plain(src, idx))


@pytest.mark.gpu
def test_k6_refuses_what_it_does_not_take(cuda_device):
    src = torch.rand((2, 5, 2), device=cuda_device)
    idx = torch.zeros((2, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        gather_cuda.gather_points_cuda(src.double(), idx)
    with pytest.raises(TypeError, match="int64 or int32"):
        gather_cuda.gather_points_cuda(src, idx.float())
    with pytest.raises(ValueError, match="contiguous"):
        gather_cuda.gather_points_cuda(src, idx.t().contiguous().t())
    with pytest.raises(ValueError, match="aligned"):
        gather_cuda.gather_points_cuda(src.reshape(-1)[1:17].reshape(2, 4, 2), idx)
    with pytest.raises(ValueError, match=r"\[G, P\]"):
        gather_cuda.gather_points_cuda(src, idx[:1])
    with pytest.raises(ValueError, match=r"\[G, NS, 2\]"):
        gather_cuda.gather_points_cuda(src[..., 0].contiguous(), idx)
    # the C function refuses, before any arithmetic, a width it has no kernel
    # for (0, 2, -4) and 4 points a thread on a misaligned index
    out = torch.empty((2, 3, 2), device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    fn = gather_cuda._kernel("gather_points")
    for vec, index in ((0, idx), (2, idx), (-4, idx), (4, idx.reshape(-1)[1:].reshape(1, 5))):
        assert fn(src.data_ptr(), index.data_ptr(), out.data_ptr(), 2, 5, 3, 8, vec,
                  stream) == 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="launch failed"):
        gather_cuda.gather_floor_cuda(src[:1], idx.reshape(-1)[1:].reshape(1, 5), "stream")


@pytest.mark.gpu
def test_criterion_fallback_takes_k6(cuda_device):
    """Candidates that the stratified chunk does not divide (64 points, as
    the tiny training configurations) go through top-k and K6, and select
    the same points as the exact top-k and torch.gather."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    M, num_points = 6, 64
    logits = torch.randn((M, 16, 16), generator=g, device=cuda_device)
    cand = torch.rand((M, 3 * num_points, 2), generator=g, device=cuda_device)
    tail = torch.rand((M, num_points // 4, 2), generator=g, device=cuda_device)
    before = gather_cuda.launches
    got = uncertainty_sampled_points(logits, cand, tail, num_points, 0.75)
    assert gather_cuda.launches == before + 1
    want = uncertainty_sampled_points(logits, cand, tail, num_points, 0.75, exact_topk=True)
    assert gather_cuda.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
