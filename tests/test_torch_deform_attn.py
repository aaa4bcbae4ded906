"""Deformable attention in the PyTorch port: the plain version and its
gradients against the JAX composition and the Pallas kernels (interpret
mode), and the device dispatch. The hand-written kernels K1 and K2 are
checked on the card by tests/test_torch_k1_card.py and
tests/test_torch_k234_card.py.

Inputs are made with numpy from a seed and handed to both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combo_avs_tpu.ops.deform_attn import ms_deform_attn as jax_ms_deform_attn
from combo_avs_tpu.ops.deform_attn_pallas import _backward_hfuse, _forward_hfuse
from combo_avs_torch.ops import deform_attn_cuda
from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401 (autouse fixtures)

SHAPES = ((4, 6), (2, 3), (5, 5))
B, M, D, Lq, P = 2, 2, 8, 37, 3
S = sum(h * w for h, w in SHAPES)


def _inputs(seed=0, shapes=SHAPES, b=B, m=M, d=D, lq=Lq, p=P):
    """Locations in [-0.2, 1.2] (corners outside the levels) with a third of
    them on exact pixel centres (integer sample coordinates)."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, m, d).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (b, lq, m, len(shapes), p, 2)).astype(np.float32)
    for lvl, (h, w) in enumerate(shapes):
        on_pixel = rng.rand(b, lq, m, p) < 0.33
        loc[:, :, :, lvl, :, 0] = np.where(on_pixel, (rng.randint(0, w, on_pixel.shape) + 0.5) / w,
                                           loc[:, :, :, lvl, :, 0])
        loc[:, :, :, lvl, :, 1] = np.where(on_pixel, (rng.randint(0, h, on_pixel.shape) + 0.5) / h,
                                           loc[:, :, :, lvl, :, 1])
    wts = rng.rand(b, lq, m, len(shapes), p).astype(np.float32)
    wts /= wts.reshape(b, lq, m, -1).sum(-1)[..., None, None]
    return value, loc, wts


def _plain(value, loc, wts, shapes=SHAPES):
    t = [torch.from_numpy(np.asarray(a)) for a in (value, loc, wts)]
    return ms_deform_attn_plain(t[0], shapes, t[1], t[2]).numpy()


def test_plain_matches_jax_fp32():
    # same fp32 products, summed in another order: 1e-5
    value, loc, wts = _inputs(0)
    want = np.asarray(jax_ms_deform_attn(value, SHAPES, loc, wts))
    got = _plain(value, loc, wts)
    assert got.shape == want.shape == (B, Lq, M * D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_plain_matches_jax_fp64():
    # the same algorithm in float64: agreement to rounding, 1e-10
    value, loc, wts = (a.astype(np.float64) for a in _inputs(1))
    with jax.enable_x64(True):
        want = np.asarray(jax_ms_deform_attn(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                             jnp.asarray(wts)))
    got = _plain(value, loc, wts)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=1e-10)


def test_plain_matches_pallas_hfuse_interpret():
    # the TPU kernel's tent-matrix form at HIGHEST precision: 1e-5
    value, loc, wts = _inputs(2)
    want = np.asarray(_forward_hfuse(value, SHAPES, loc, wts, interpret=True))
    np.testing.assert_allclose(_plain(value, loc, wts), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fill", [-0.6, 1.6])
def test_out_of_level_is_exact_zero(fill):
    # x*W - 0.5 and y*H - 0.5 lie beyond [-1, W] for every level: no corner is inside
    value, loc, wts = _inputs(3)
    out = _plain(value, np.full_like(loc, fill), wts)
    np.testing.assert_array_equal(out, 0.0)


def test_integer_coordinates_read_exact_pixels():
    # at pixel centres bilinear sampling is a plain read: out = sum_l,p w * value[pixel]
    rng = np.random.RandomState(4)
    value, _, wts = _inputs(4)
    L = len(SHAPES)
    ix = np.stack([rng.randint(0, w, (B, Lq, M, P)) for _, w in SHAPES], 3)
    iy = np.stack([rng.randint(0, h, (B, Lq, M, P)) for h, _ in SHAPES], 3)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)
    loc = (np.stack([ix, iy], -1) + 0.5) / wh[None, None, None, :, None, :]
    starts = np.cumsum([0] + [h * w for h, w in SHAPES])[:-1]
    want = np.zeros((B, Lq, M, D), np.float64)
    for b in range(B):
        for m in range(M):
            for lvl in range(L):
                row = starts[lvl] + iy[b, :, m, lvl] * SHAPES[lvl][1] + ix[b, :, m, lvl]  # [Lq, P]
                want[b, :, m] += np.einsum("qp,qpd->qd", wts[b, :, m, lvl], value[b, row, m])
    np.testing.assert_allclose(_plain(value, loc.astype(np.float32), wts),
                               want.reshape(B, Lq, M * D), atol=1e-5, rtol=1e-5)


def test_bf16_value_matches_jax():
    # bf16 value, fp32 locations/weights, fp32 accumulation, one bf16 rounding of
    # the output on both sides: at most one bf16 ulp apart (2^-8 relative)
    value, loc, wts = _inputs(5)
    v16 = torch.from_numpy(value).to(torch.bfloat16)
    got = ms_deform_attn_plain(v16, SHAPES, torch.from_numpy(loc), torch.from_numpy(wts))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_ms_deform_attn(jnp.asarray(value, jnp.bfloat16), SHAPES, loc, wts)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=2**-8)


# TTA's 384^2 branch at a small size: the pixel decoder's levels (res5, res4,
# res3) of a 96^2 frame, the layout whose res3 level, at 384^2, is too large
# for one block's copy of the slice (the grouped plan)
TTA_LEVELS = ((3, 3), (6, 6), (12, 12))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10), ("bfloat16", 2**-8)])
def test_plain_matches_jax_at_the_tta_levels(dtype, tol):
    """At the TTA layout, 2 frames x 2 heads x 8 channels, every query of
    the 189 tokens: fp32 the same products in another order (1e-5), fp64
    rounding (1e-10), a bf16 value with fp32 sums rounded to bf16 once on
    both sides (one bf16 ulp, 2^-8 relative, 1e-2 absolute)."""
    s = sum(h * w for h, w in TTA_LEVELS)
    value, loc, wts = _inputs(9, shapes=TTA_LEVELS, lq=s, p=4)
    if dtype == "float64":
        value, loc, wts = (a.astype(np.float64) for a in (value, loc, wts))
        with jax.enable_x64(True):
            want = np.asarray(jax_ms_deform_attn(jnp.asarray(value), TTA_LEVELS,
                                                 jnp.asarray(loc), jnp.asarray(wts)))
        got = _plain(value, loc, wts, TTA_LEVELS)
        atol = tol
    elif dtype == "bfloat16":
        got = ms_deform_attn_plain(torch.from_numpy(value).to(torch.bfloat16), TTA_LEVELS,
                                   torch.from_numpy(loc), torch.from_numpy(wts)).float().numpy()
        want = np.asarray(jax_ms_deform_attn(jnp.asarray(value, jnp.bfloat16), TTA_LEVELS, loc,
                                             wts).astype(jnp.float32))
        atol = 1e-2
    else:
        want = np.asarray(jax_ms_deform_attn(value, TTA_LEVELS, loc, wts))
        got = _plain(value, loc, wts, TTA_LEVELS)
        atol = tol
    assert got.shape == want.shape == (B, s, M * D)
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol)


def test_cpu_dispatch_takes_plain_path():
    value, loc, wts = (torch.from_numpy(a) for a in _inputs(6))
    before = deform_attn_cuda.launches
    out = deform_attn_cuda.ms_deform_attn(value, SHAPES, loc, wts)
    assert deform_attn_cuda.launches == before
    torch.testing.assert_close(out, ms_deform_attn_plain(value, SHAPES, loc, wts), rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    value, loc, wts = (torch.from_numpy(a) for a in _inputs(7))
    with pytest.raises(ValueError, match="CUDA"):
        deform_attn_cuda.ms_deform_attn_cuda(value, SHAPES, loc, wts)


def _plain_grads(value, loc, wts, g, shapes=SHAPES):
    t = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in (value, loc, wts)]
    ms_deform_attn_plain(t[0], shapes, t[1], t[2]).backward(torch.from_numpy(g))
    return [a.grad.numpy() for a in t]


def test_plain_gradients_match_jax_vjp_fp64():
    """dvalue, dlocations and dweights of the plain version (autograd) against
    jax.vjp of the JAX composition, in float64 with a third of the points on
    exact pixel centres: 1e-10 of each gradient's scale."""
    value, loc, wts = (a.astype(np.float64) for a in _inputs(8))
    g = np.random.RandomState(9).randn(B, Lq, M * D)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda v, l, w: jax_ms_deform_attn(v, SHAPES, l, w),
                         jnp.asarray(value), jnp.asarray(loc), jnp.asarray(wts))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    for got, exp in zip(_plain_grads(value, loc, wts, g), want):
        assert got.shape == exp.shape and got.dtype == np.float64
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-10 * max(1.0, np.abs(exp).max()))


def test_plain_gradients_match_pallas_backward_interpret():
    """The TPU's K2 (`_backward_hfuse`, tent-matrix form, HIGHEST precision)
    in interpret mode against the plain version's autograd in fp32: the same
    products summed in another order, 1e-5 of each gradient's scale."""
    value, loc, wts = _inputs(10)
    g = np.random.RandomState(11).randn(B, Lq, M * D).astype(np.float32)
    want = [np.asarray(x) for x in _backward_hfuse(value, SHAPES, loc, wts, g, interpret=True)]
    for got, exp in zip(_plain_grads(value, loc, wts, g), want):
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5 * np.abs(exp).max())


def test_cpu_dispatch_gradcheck_fp64():
    """torch.autograd.gradcheck of the CPU dispatch in float64, at locations
    away from integer sample coordinates (the corner split is a step there)."""
    shapes = ((3, 4), (2, 2))
    rng = np.random.RandomState(12)
    value = torch.from_numpy(rng.randn(1, 16, 2, 4)).requires_grad_()
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (1, 5, 2, 2, 2, 2))).requires_grad_()
    wts = torch.from_numpy(rng.rand(1, 5, 2, 2, 2)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v, l, w: deform_attn_cuda.ms_deform_attn(v, shapes, l, w), (value, loc, wts),
        eps=1e-7, atol=1e-6)


H100_OPTIN = 232448  # an H100's opt-in shared memory per block (227 KB)
MAIN_LEVELS = ((7, 7), (14, 14), (28, 28))  # the main path's levels at 224^2
# name: (levels, Lq, M, D, P, opt-in bytes) -> (kernel, threads, blocks per frame, smem bytes);
# the level-slice kernel's shared memory at D = 32, P = 4 and 24 warps is
# (2 rows + 24 x 8) x 128 bytes: 812 rows fit 232,448 bytes, 813 do not
BWD_PLANS = {
    "train": ((MAIN_LEVELS, 1029, 8, 32, 4, H100_OPTIN), ("level_slice", 768, 24, 225280)),
    "one_row_over": ((((7, 7), (3, 271)), 862, 8, 32, 4, H100_OPTIN),
                     ("global", 256, 862, 0)),
    "at_limit": ((((28, 29), (7, 7)), 861, 8, 32, 4, H100_OPTIN),
                 ("level_slice", 768, 16, 232448)),
    "ragged": ((((3, 5), (6, 10)), 37, 3, 16, 4, H100_OPTIN), ("level_slice", 768, 6, 19968)),
    "d16_m3": ((MAIN_LEVELS, 1029, 3, 16, 4, H100_OPTIN), ("level_slice", 768, 9, 112640)),
    "p3": ((MAIN_LEVELS, 1029, 8, 32, 3, H100_OPTIN), ("level_slice", 768, 24, 231424)),
    "no_optin": ((MAIN_LEVELS, 1029, 8, 32, 4, 48 * 1024), ("global", 256, 1029, 0)),
}
# bf16 (the AMP step): the staged value rows take 2 bytes an element, rounded
# up to 16 bytes, the dvalue and grad rows stay fp32: 64 + 128 bytes a row at
# D = 32 beside the 24 x 8 grad rows, so 1082 rows fit 232,448 bytes, 1083 do not
BWD_PLANS_BF16 = {
    "avss_bf16": ((MAIN_LEVELS, 1029, 8, 32, 4, H100_OPTIN), ("level_slice", 768, 24, 175104)),
    "at_limit_bf16": ((((7, 7), (2, 541)), 1131, 8, 32, 4, H100_OPTIN),
                      ("level_slice", 768, 16, 232320)),
    "one_row_over_bf16": ((((7, 7), (3, 361)), 1132, 8, 32, 4, H100_OPTIN),
                          ("global", 256, 1132, 0)),
    "ragged_bf16": ((((3, 5), (6, 10)), 37, 3, 16, 4, H100_OPTIN),
                    ("level_slice", 768, 6, 18048)),
}


@pytest.mark.parametrize("case", sorted(BWD_PLANS) + sorted(BWD_PLANS_BF16))
def test_bwd_launch_plan(case):
    """K2's launch plan is a pure function of the shapes, the value's element
    size and the card's opt-in limit: the level-slice kernel exactly when its
    shared memory for the largest level (value and dvalue rows, each warp's
    grad rows) fits it, else the global one; and the C function's int array
    carries the value type, the plan and the level shapes."""
    esize = 2 if case in BWD_PLANS_BF16 else 4
    (levels, lq, m, d, p, optin), want = {**BWD_PLANS, **BWD_PLANS_BF16}[case]
    plan = deform_attn_cuda.bwd_launch_plan(levels, lq, m, d, p, optin, esize)
    assert tuple(plan) == want
    s = sum(h * w for h, w in levels)
    args = deform_attn_cuda.plan_args(3, s, lq, m, d, p, levels, plan, esize)
    assert list(args) == [3, s, lq, m, d, len(levels), p, int(esize == 2),
                          int(want[0] == "level_slice"), *want[1:],
                          *[n for hw in levels for n in hw]]


H100_SMS = 132  # an H100 SXM's streaming multiprocessors
TTA384_LEVELS = ((12, 12), (24, 24), (48, 48))  # the pixel decoder's levels at 384^2
# name: (levels, frames, Lq, M, D, P, element size, opt-in bytes) -> (kernel, threads, chunk,
# blocks per frame, smem bytes, channel groups), on 132 SMs. The staged kernel's shared memory
# is the (frame, head) slice, S x D elements rounded up to 16 bytes, plus each of its 32 warps'
# corner table, 32 B a point for each of 32 / lanes queries (lanes: D / 4 when D % 4 == 0,
# else D / 2 bf16 pairs or D, rounded up to a power of two). The grouped plan's block holds the
# whole slice or a channel group's rows and the same tables at 24-32 warps. Query chunks per
# (frame, head) are the fewest whose frames x M x groups x chunks blocks fill their waves of
# 132 to 90% (grouped: 95%), at most 8, else the best filled: 3 at 20 frames x 8 heads (480 of
# 528), 2 at 40 (640 of 660)
FWD_PLANS = {
    "eval_fp32": ((MAIN_LEVELS, 20, 1029, 8, 32, 4, 4, H100_OPTIN),
                  ("staged", 1024, 343, 24, 1029 * 32 * 4 + 32 * 4 * 12 * 32, 1)),  # 180,864
    "eval_bf16": ((MAIN_LEVELS, 20, 1029, 8, 32, 4, 2, H100_OPTIN),
                  ("staged", 1024, 343, 24, 1029 * 32 * 2 + 32 * 4 * 12 * 32, 1)),  # 115,008
    "train_fp32": ((MAIN_LEVELS, 40, 1029, 8, 32, 4, 4, H100_OPTIN),
                   ("staged", 1024, 515, 16, 180864, 1)),
    "train_bf16": ((MAIN_LEVELS, 40, 1029, 8, 32, 4, 2, H100_OPTIN),
                   ("staged", 1024, 515, 16, 115008, 1)),
    # one frame: 8 chunks, 64 blocks, the best a single wave gets; 4 frames: 4 (128 of 132);
    # 80 frames: 1 (640 of 660)
    "one_frame": ((MAIN_LEVELS, 1, 1029, 8, 32, 4, 4, H100_OPTIN),
                  ("staged", 1024, 129, 64, 180864, 1)),
    "four_frames": ((MAIN_LEVELS, 4, 1029, 8, 32, 4, 4, H100_OPTIN),
                    ("staged", 1024, 258, 32, 180864, 1)),
    "eighty_frames": ((MAIN_LEVELS, 80, 1029, 8, 32, 4, 4, H100_OPTIN),
                      ("staged", 1024, 1029, 8, 180864, 1)),
    "main_fp32_at_limit": ((MAIN_LEVELS, 20, 1029, 8, 32, 4, 4, 180864),
                           ("staged", 1024, 343, 24, 180864, 1)),
    # one byte short of the 32-warp staged block: the grouped plan keeps the whole slice at 28
    # warps (1,536 B of tables a warp), its chunks filling waves to 95%: 4 (640 of 660 blocks)
    "main_fp32_one_byte_short": ((MAIN_LEVELS, 20, 1029, 8, 32, 4, 4, 180863),
                                 ("grouped", 896, 258, 32, 1029 * 32 * 4 + 28 * 1536, 1)),
    "no_optin": ((MAIN_LEVELS, 20, 1029, 8, 32, 4, 4, 0), ("global", 256, 0, 1029, 0, 1)),
    "no_optin_bf16": ((MAIN_LEVELS, 20, 1029, 8, 32, 4, 2, 0), ("global", 256, 0, 1029, 0, 1)),
    # TTA at 384^2: a 48^2 res3 level, S = 3024: 387 KB of slice in fp32, 194 KB in bf16, which
    # with 32 warps' tables (49 KB) does not fit either. The grouped plan: in bf16 the whole
    # slice at 24 warps (1,536 B of tables a warp), 4 chunks; in fp32 2 channel groups of 16
    # (193,536 B of rows), the same 8 lanes a query (2 channels a lane) at 24 warps, 2 chunks:
    # 640 blocks each (of 660)
    "res3_48_fp32": ((TTA384_LEVELS, 20, 3024, 8, 32, 4, 4, H100_OPTIN),
                     ("grouped", 768, 1512, 32, 3024 * 16 * 4 + 24 * 1536, 2)),  # 230,400
    "res3_48_bf16": ((TTA384_LEVELS, 20, 3024, 8, 32, 4, 2, H100_OPTIN),
                     ("grouped", 768, 756, 32, 3024 * 32 * 2 + 24 * 1536, 1)),  # 230,400
    # below 24 warps of 2 groups in fp32 (230,400 B), the next count: 4 groups at 32 warps
    "res3_48_fp32_4_groups": ((TTA384_LEVELS, 20, 3024, 8, 32, 4, 4, 230399),
                              ("grouped", 1024, 3024, 32, 3024 * 8 * 4 + 32 * 1536, 4)),
    # global where no grouped block fits either (a 300^2 level: 4 groups are 1.4 MB in fp32)
    "no_group_fits": ((((300, 300),), 2, 100, 8, 32, 4, 4, H100_OPTIN),
                      ("global", 256, 0, 100, 0, 1)),
    "tta384_no_optin": ((TTA384_LEVELS, 20, 3024, 8, 32, 4, 2, 0), ("global", 256, 0, 3024, 0, 1)),
    # TTA at 128^2: the whole slice fits, staged as before
    "tta128_bf16": ((((4, 4), (8, 8), (16, 16)), 20, 336, 8, 32, 4, 2, H100_OPTIN),
                    ("staged", 1024, 112, 24, 336 * 32 * 2 + 32 * 4 * 12 * 32, 1)),  # 70,656
    # D = 16 with 2 levels: 4 lanes a query (8 queries a warp), fp32 and bf16; 3 frames x 3
    # heads fill a wave best at 8 chunks of 5 queries, 8 blocks a head
    "d16_l2_fp32": ((((3, 5), (6, 10)), 3, 37, 3, 16, 4, 4, H100_OPTIN),
                    ("staged", 1024, 5, 24, 75 * 16 * 4 + 32 * 8 * 8 * 32, 1)),  # 70,336
    "d16_l2_bf16": ((((3, 5), (6, 10)), 3, 37, 3, 16, 4, 2, H100_OPTIN),
                    ("staged", 1024, 5, 24, 75 * 16 * 2 + 32 * 8 * 8 * 32, 1)),  # 67,936
    # 4 levels, 16 points a query
    "l4_fp32": ((((2, 2), (4, 4), (8, 8), (16, 16)), 20, 340, 8, 32, 4, 4, H100_OPTIN),
                ("staged", 1024, 114, 24, 340 * 32 * 4 + 32 * 4 * 16 * 32, 1)),  # 109,056
    # odd D in bf16: one element a lane (16 lanes, 2 queries a warp), rows of 26 bytes, the
    # slice rounded up to 16 bytes
    "d13_bf16": ((((3, 5), (6, 10)), 3, 37, 3, 13, 4, 2, H100_OPTIN),
                 ("staged", 1024, 5, 24, 1952 + 32 * 2 * 8 * 32, 1)),  # 75 * 26 = 1950 -> 1952
}


@pytest.mark.parametrize("case", sorted(FWD_PLANS))
def test_fwd_launch_plan(case):
    """K1's launch plan is a pure function of the shapes, value's element
    size and the card's opt-in limit and SM count: the staged kernel exactly
    when its shared memory (the whole (frame, head) value slice and 32
    warps' corner tables) fits it, else the grouped plan where a block of
    24-32 warps of the whole slice or of a channel group fits, the query
    chunk set by how the blocks fill the SMs' waves, else the global one;
    and the C function's int array carries the plan, its channel groups,
    the dtype and the level shapes."""
    (levels, b, lq, m, d, p, esize, optin), want = FWD_PLANS[case]
    plan = deform_attn_cuda.fwd_launch_plan(levels, b, lq, m, d, p, esize, optin, H100_SMS)
    assert tuple(plan) == want
    assert plan == deform_attn_cuda.fwd_launch_plan(levels, b, lq, m, d, p, esize, optin,
                                                    H100_SMS)
    s = sum(h * w for h, w in levels)
    args = deform_attn_cuda.fwd_plan_args(b, s, lq, m, d, p, esize, levels, plan)
    assert list(args) == [b, s, lq, m, d, len(levels), p, int(esize == 2),
                          ("global", "staged", "grouped").index(want[0]), *want[1:],
                          *[n for hw in levels for n in hw]]


# the eval and training shapes at 224^2 (20 and 40 frames, fp32 and bf16): the staged plans,
# which every path but TTA's 384^2 branch launches, keep their block, chunks and memory
STAGED_224 = {(20, 4): (343, 24, 180864), (20, 2): (343, 24, 115008),
              (40, 4): (515, 16, 180864), (40, 2): (515, 16, 115008)}


@pytest.mark.parametrize("frames,esize", sorted(STAGED_224))
def test_fwd_launch_plan_keeps_the_224_plans(frames, esize):
    chunk, blocks, smem = STAGED_224[frames, esize]
    plan = deform_attn_cuda.fwd_launch_plan(MAIN_LEVELS, frames, 1029, 8, 32, 4, esize,
                                            H100_OPTIN, H100_SMS)
    assert plan == ("staged", 1024, chunk, blocks, smem, 1)


@pytest.mark.parametrize("D,esize,groups", [(32, 4, (1, 2, 4)), (32, 2, (1,)),
                                            (16, 4, (1, 2, 4)), (16, 2, (1,)), (13, 2, (1,)),
                                            (24, 2, (1,))])
def test_grouped_fits(D, esize, groups):
    """A grouped block holds the whole slice (1 group) or, in fp32 only, a
    channel group with the staged plan's lanes a query (8 at D = 32, 4 at D
    = 16), each lane taking 1, 2 or 4 of the group's channels, and rows of
    a multiple of 16 bytes; bf16 takes no channel groups (its kernel has
    none), whatever D."""
    assert tuple(g for g in range(1, D + 1)
                 if deform_attn_cuda.grouped_fits(D, esize, g)) == groups


def test_grouped_bytes():
    """The grouped block's shared memory: its group's rows, and the corner
    tables of the staged plan at the same warps (the lanes a query do not
    change with the groups)."""
    sb = deform_attn_cuda.staged_bytes
    assert sb(TTA384_LEVELS, 32, 4, 2, 1024, 2) == 3024 * 16 * 2 + 32 * 4 * 12 * 32
    assert sb(TTA384_LEVELS, 32, 4, 4, 800, 2) == 3024 * 16 * 4 + 25 * 4 * 12 * 32
    assert sb(TTA384_LEVELS, 32, 4, 4, 1024, 4) == 3024 * 8 * 4 + 32 * 4 * 12 * 32
    tables = sb(MAIN_LEVELS, 32, 4, 4, 1024) - 1029 * 32 * 4
    assert sb(MAIN_LEVELS, 32, 4, 4, 1024, 2) == 1029 * 16 * 4 + tables
    # warps a multiple of 4: the whole bf16 slice fits 25 warps' tables, the plan takes 24
    assert deform_attn_cuda.grouped_layout(TTA384_LEVELS, 32, 4, 4, H100_OPTIN) == (2, 768)
    assert deform_attn_cuda.grouped_layout(TTA384_LEVELS, 32, 4, 2, H100_OPTIN) == (1, 768)
    assert deform_attn_cuda.grouped_layout(((300, 300),), 32, 4, 4, H100_OPTIN) is None


def test_fwd_launch_plan_forced():
    """A caller names another plan for `ms_deform_attn_cuda(plan=)`: global
    through an opt-in limit of 0, a staged plan above the card's limit
    through an unbounded one (its launch must then raise), or a staged plan
    at other warp and chunk counts built from `staged_bytes`, as the sweep
    builds them."""
    assert deform_attn_cuda.fwd_launch_plan(MAIN_LEVELS, 20, 1029, 8, 32, 4, 4, 0,
                                            H100_SMS).kernel == "global"
    plan = deform_attn_cuda.fwd_launch_plan(TTA384_LEVELS, 20, 3024, 8, 32, 4, 4, 2**31, H100_SMS)
    assert plan.kernel == "staged" and plan.smem_bytes == 3024 * 32 * 4 + 32 * 4 * 12 * 32
    assert plan.smem_bytes > H100_OPTIN
    # the grouped block at 32 warps, over the limit in fp32 (242,688 B), as the sweep builds it
    plan = deform_attn_cuda.staged_plan(TTA384_LEVELS, 3024, 8, 32, 4, 4, 1024, 2, 2, "grouped")
    assert plan == ("grouped", 1024, 1512, 32, 3024 * 16 * 4 + 32 * 1536, 2)
    assert plan.smem_bytes > H100_OPTIN
    # 8 warps: the slice and 8 warps' tables of 4 queries x 12 points
    assert deform_attn_cuda.staged_bytes(MAIN_LEVELS, 32, 4, 4, 256) == 131712 + 8 * 4 * 12 * 32
    assert deform_attn_cuda.staged_bytes(MAIN_LEVELS, 32, 4, 4) == 180864


@pytest.mark.parametrize("source,name,argtypes", [
    (deform_attn_cuda.SOURCE, "ms_deform_attn_fwd", deform_attn_cuda.FWD_ARGTYPES),
    (deform_attn_cuda.BWD_SOURCE, "ms_deform_attn_bwd", deform_attn_cuda.BWD_ARGTYPES),
], ids=["fwd", "bwd"])
def test_argtypes_match_the_c_signature(source, name, argtypes):
    """ctypes passes exactly the C function's arguments: a count or a type
    off would shift the stream into an int (the kernels cannot run here)."""
    from tests.test_torch_point_sample import c_signature

    assert argtypes == c_signature(source, name)
