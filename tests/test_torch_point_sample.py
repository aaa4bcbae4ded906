"""PointRend point sampling in the PyTorch port: the plain version and its
autograd against the JAX composition (`combo_avs_tpu.ops.grid_sample.
point_sample`) and against the TPU kernels it replaces, run in interpret
mode (`point_sample_pallas._forward`, `_backward`, `point_sample_shared`).
The CUDA kernels are checked on the card by tests/test_torch_k234_card.py.

Inputs are made with numpy from a seed and handed to both frameworks. They
cover points on exact pixel centres and on the image's corners and edges
(the image sides are powers of two, so p * W - 0.5 is exact on both sides
and both split the coordinate at the same corner), points outside [0, 1]
(zero padding), and C = 1 and C > 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combo_avs_tpu.ops import point_sample_pallas as psp
from combo_avs_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from combo_avs_tpu.ops.grid_sample import point_sample as jax_point_sample
from combo_avs_torch.ops import point_sample_cuda
from combo_avs_torch.ops.grid_sample import grid_sample, point_sample, point_sample_plain
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401 (autouse fixtures)


def _inputs(N, H, W, C, P, seed, dtype=np.float64):
    """feat [N, H, W, C]; points: a third uniform in [-0.3, 1.3], a third on
    pixel centres, the rest on the image's corners, edges and centre."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(N, H, W, C)
    pts = rng.uniform(-0.3, 1.3, (N, P, 2))
    n = P // 3
    pts[:, n:2 * n, 0] = (rng.randint(0, W, (N, n)) + 0.5) / W
    pts[:, n:2 * n, 1] = (rng.randint(0, H, (N, n)) + 0.5) / H
    edges = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0.5], [0, 0.5], [1, 0.25]])
    rest = P - 2 * n
    pts[:, 2 * n:] = edges[np.arange(rest) % len(edges)]
    return feat.astype(dtype), pts.astype(dtype)


def _plain_with_grads(feat, pts, g):
    f = torch.from_numpy(feat).requires_grad_()
    p = torch.from_numpy(pts).requires_grad_()
    out = point_sample_plain(f, p)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), f.grad.numpy(), p.grad.numpy()


@pytest.mark.parametrize("shape", [(2, 8, 16, 1, 90), (3, 16, 8, 5, 61), (2, 8, 16, 3, 91),
                                   (3, 16, 8, 4, 64), (1, 1, 12289, 1, 257)],
                         ids=["C1", "C5", "C3_P_odd", "C4", "one_over_stage_limit"])
def test_plain_matches_jax_fp64(shape):
    """The same function in float64: values and both gradients to 1e-12. The
    edge shapes of the CUDA forward's launch plan are among them: odd P
    (scalar tail), C = 3 and 4 (channels in registers) and an image of
    12289 floats, one over what fits in shared memory (48 KB). Its side is
    not a power of two, so its points lie on multiples of 2^-10, where p * W
    is exact on both sides."""
    N, H, W, C, P = shape
    feat, pts = _inputs(N, H, W, C, P, seed=C)
    if W & (W - 1):
        pts = np.round(pts * 1024) / 1024
    g = np.random.RandomState(10 + C).randn(N, P, C)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(jax_point_sample, jnp.asarray(feat), jnp.asarray(pts))
        want_df, want_dp = vjp(jnp.asarray(g))
    got, df, dp = _plain_with_grads(feat, pts, g)
    assert got.shape == (N, P, C) and got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(df, np.asarray(want_df), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dp, np.asarray(want_dp), rtol=0, atol=1e-12)


def test_grid_sample_matches_jax_fp64():
    rng = np.random.RandomState(3)
    img = rng.randn(2, 8, 4, 3)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 7, 2))
    with jax.enable_x64(True):
        want = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 8, 16, 1, 700), (3, 16, 8, 3, 300), (2, 8, 16, 4, 301)],
                         ids=["C1", "C3", "C4_P_odd"])
def test_plain_matches_pallas_interpret_fp32(shape):
    """The TPU kernel's tent-matrix form (K3 forward, K4 backward) in
    interpret mode: the same fp32 products summed in another order, 1e-5."""
    N, H, W, C, P = shape
    feat, pts = _inputs(N, H, W, C, P, seed=20 + C, dtype=np.float32)
    g = np.random.RandomState(30 + C).randn(N, P, C).astype(np.float32)
    want = np.asarray(psp._forward(jnp.asarray(feat), jnp.asarray(pts), interpret=True))
    want_df, want_dp = psp._backward(jnp.asarray(feat), jnp.asarray(pts), jnp.asarray(g),
                                     interpret=True)
    got, df, dp = _plain_with_grads(feat, pts, g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(df, np.asarray(want_df), rtol=1e-5, atol=1e-5)
    # dpoints carry the factor (W, H): 1e-5 of the largest
    scale = float(np.abs(np.asarray(want_dp)).max())
    np.testing.assert_allclose(dp, np.asarray(want_dp), rtol=0, atol=1e-5 * scale)


def test_plain_matches_shared_points_kernel_interpret_fp32():
    """K5, the matcher's shared-points kernel: C channels at one point set."""
    feat, pts = _inputs(2, 16, 16, 12, 260, seed=4, dtype=np.float32)
    want = np.asarray(psp.point_sample_shared(jnp.asarray(feat), jnp.asarray(pts),
                                              interpret=True))
    got = point_sample_plain(torch.from_numpy(feat), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_outside_points_are_exact_zero():
    feat, _ = _inputs(1, 8, 8, 2, 4, seed=5)
    # beyond half a pixel outside the image no corner is inside
    pts = np.array([[[-0.07, 0.5], [1.07, 0.5], [0.5, -0.07], [0.5, 1.07]]])
    np.testing.assert_array_equal(
        point_sample_plain(torch.from_numpy(feat), torch.from_numpy(pts)).numpy(), 0.0)


def test_cpu_dispatch_takes_plain_path():
    feat, pts = (torch.from_numpy(a) for a in _inputs(2, 8, 8, 3, 30, seed=6, dtype=np.float32))
    before = (point_sample_cuda.fwd_launches, point_sample_cuda.dimg_launches,
              point_sample_cuda.dxy_launches)
    out = point_sample(feat, pts)
    assert (point_sample_cuda.fwd_launches, point_sample_cuda.dimg_launches,
            point_sample_cuda.dxy_launches) == before
    torch.testing.assert_close(out, point_sample_plain(feat, pts), rtol=0, atol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    feat, pts = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 1, 9, seed=7, dtype=np.float32))
    g = torch.ones(1, 9, 1)
    with pytest.raises(ValueError, match="CUDA"):
        point_sample_cuda.point_sample_fwd_cuda(feat, pts)
    with pytest.raises(ValueError, match="CUDA"):
        point_sample_cuda.point_sample_dimg_cuda(pts, g, (8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        point_sample_cuda.point_sample_dxy_cuda(feat, pts, g)


@pytest.mark.parametrize("C,group", [(1, 0), (2, 1), (3, 2), (4, 2), (5, 3), (32, 5),
                                     (33, 5), (100, 5)])
def test_lanes_per_point(C, group):
    """The backward kernels give each point the smallest power of two of
    lanes that covers its channels, at most a warp."""
    assert point_sample_cuda._log2_group(C) == group


STEP = point_sample_cuda.THREADS * point_sample_cuda.POINTS_PER_THREAD


@pytest.mark.parametrize("H,W,C,staged", [
    (56, 56, 1, True),  # the criterion's masks
    (56, 56, 3, True),  # 37632 bytes
    (64, 64, 3, True),  # 49152 bytes: exactly the limit
    (1, 12288, 1, True),
    (1, 12289, 1, False),  # one float over the limit
    (56, 56, 4, False),  # 50176 bytes
    (224, 224, 1, False),  # the point labels' masks
    (224, 224, 3, False),  # the matcher's targets
])
def test_plan_stages_exactly_when_the_image_fits(H, W, C, staged):
    """C <= 4 images of at most 48 KB go to the staged kernel, the rest to the
    channels kernel, which gathers from global memory."""
    plan = point_sample_cuda.launch_plan(120, H, W, C, 12544)
    assert plan.kernel == ("staged" if staged else "channels")


@pytest.mark.parametrize("N,H,W,C,P", [
    (120, 56, 56, 1, 37632), (120, 56, 56, 1, 12544), (120, 224, 224, 1, 12544),
    (40, 224, 224, 3, 12544), (40, 56, 56, 100, 12544), (3, 7, 5, 33, 101), (1, 8, 8, 2, 1),
    (5000, 56, 56, 1, 3), (2, 16, 16, 7, 100000), (70000, 2, 2, 1, 5),
])
def test_plan_grid_covers_every_point(N, H, W, C, P):
    """Every point of every image falls in exactly one block: the point
    blocks tile [0, P) with no block wholly past it, and the image rows of the
    grid, looping in steps of the row count, reach all N images."""
    plan = point_sample_cuda.launch_plan(N, H, W, C, P)
    blocks, rows = plan.grid
    assert blocks * plan.points_per_block >= P > (blocks - 1) * plan.points_per_block
    assert rows == min(N, point_sample_cuda.GRID_ROWS) and sorted(
        {n % rows for n in range(0, N, max(1, N // 1000))} | set(range(rows))) == list(range(rows))
    if plan.kernel == "staged":
        assert C <= 4 and plan.points_per_block % STEP == 0
    else:
        assert 1 <= plan.points_per_block <= point_sample_cuda.MAX_CHANNEL_POINTS


def test_plan_folds_images_beyond_the_grid_rows():
    """N above the grid's 65535 rows: the grid keeps 65535 rows and each
    loops over the images n, n + 65535, ... (no second launch, no error)."""
    for C in (1, 100):
        plan = point_sample_cuda.launch_plan(70000, 2, 2, C, 5)
        assert plan.grid[1] == point_sample_cuda.GRID_ROWS
        assert -(-70000 // plan.grid[1]) == 2


@pytest.mark.parametrize("H,C,P,feat_ptr,points_ptr,vec", [
    (56, 1, 12544, 0, 0, True),
    (56, 1, 12545, 0, 0, False),  # odd P: the second image's points are 8-byte aligned
    (56, 3, 12545, 0, 0, False),
    (56, 3, 12546, 0, 0, False),  # P * C not a multiple of 4: an image's outputs misalign
    (56, 2, 12548, 0, 0, True),
    (56, 1, 12544, 0, 8, False),  # points 8 bytes off a 16-byte boundary
    (56, 2, 12544, 4, 0, True),  # staged corners come from aligned shared memory
    (32, 4, 12544, 8, 0, True),
    (224, 4, 12544, 8, 0, False),  # channel units need a 16-byte aligned image
    (224, 4, 12545, 0, 8, True),  # the channels kernel reads points one float at a time
    (224, 1, 12544, 0, 0, False),  # C = 1, 3: one float a unit
    (224, 3, 12544, 0, 0, False),
])
def test_plan_takes_the_tail_safe_path(H, C, P, feat_ptr, points_ptr, vec):
    """Vector loads and stores only where every image's points, outputs and
    corners are aligned for them; otherwise the scalar path. The last points
    of an image that fill no whole thread take it too, inside the kernel."""
    plan = point_sample_cuda.launch_plan(120, H, H, C, P, feat_ptr, points_ptr)
    assert plan.kernel == ("staged" if H * H * C * 4 <= 48 * 1024 else "channels")
    assert plan.vec == vec


@pytest.mark.parametrize("feat_ptr,H,W,C,stage16", [
    (0, 56, 56, 1, True), (4, 56, 56, 1, False), (0, 7, 5, 1, False), (0, 7, 4, 1, True),
])
def test_plan_stages_in_16_bytes_only_when_aligned(feat_ptr, H, W, C, stage16):
    plan = point_sample_cuda.launch_plan(3, H, W, C, 100, feat_ptr)
    assert plan.kernel == "staged" and plan.stage16 == stage16


@pytest.mark.parametrize("H,C,feat_ptr,vec,per_block", [
    (56, 100, 0, True, 40),  # the matcher: 25 float4 units a point
    (56, 100, 4, False, 10),
    (56, 33, 0, False, 31),
    (56, 5, 0, False, 204),
    (56, 8, 0, True, 256),  # capped by the corner table
    (224, 1, 0, False, 256),  # the point labels: one unit a point
    (224, 3, 0, False, 256),  # the matcher's targets
])
def test_plan_channels_kernel(H, C, feat_ptr, vec, per_block):
    """C > 4, or an image too big to stage: the channels kernel, float4
    units when C % 4 == 0 and the image is 16-byte aligned, about 4 units a
    thread, at most 256 points a block."""
    plan = point_sample_cuda.launch_plan(40, H, H, C, 12544, feat_ptr)
    assert (plan.kernel, plan.vec, plan.points_per_block) == ("channels", vec, per_block)


OPTIN, SMS = 232448, 132  # an H100's opt-in shared memory per block and SM count


@pytest.mark.parametrize("H,W,C,optin,staged", [
    (56, 56, 1, OPTIN, True),  # the criterion's masks: a 12.5 KB accumulator
    (56, 56, 3, OPTIN, True),
    (32, 32, 4, OPTIN, True),
    (56, 56, 5, OPTIN, False),  # C > 4: the global kernel
    (7, 5, 33, OPTIN, False),
    (1, OPTIN // 4, 1, OPTIN, True),  # the shared memory fills the limit exactly
    (1, OPTIN // 4 + 1, 1, OPTIN, False),  # one element over it
    (224, 224, 1, OPTIN, True),  # 196 KB
    (224, 224, 2, OPTIN, False),  # 392 KB
    (56, 56, 1, 0, False),  # a card that offers no opt-in shared memory
])
def test_dimg_plan_stages_exactly_when_the_image_fits(H, W, C, optin, staged):
    """The image gradient sums an image in shared memory exactly when C <= 4
    and its fp32 accumulator (4 bytes an element) fits the card's opt-in
    limit (at enough images to fill the card); everything else takes the
    global kernel, which adds into a zeroed output with global atomics."""
    plan = point_sample_cuda.dimg_launch_plan(120, H, W, C, 12544, 0, 0, SMS, optin)
    assert plan.kernel == ("staged" if staged else "global")
    if staged:
        assert plan.smem_bytes == point_sample_cuda.dimg_smem_bytes(H, W, C) <= optin
        assert plan.smem_bytes >= 4 * H * W * C and plan.smem_bytes % 16 == 0
    else:
        assert plan.smem_bytes == 0 and plan.cluster == 1


@pytest.mark.parametrize("N,H,W,C,P", [
    (120, 56, 56, 1, 12544), (1, 56, 56, 1, 12544), (300, 56, 56, 1, 2000),
    (3, 32, 32, 4, 1003), (5, 56, 56, 3, 12545), (3, 7, 5, 33, 101), (1, 8, 8, 1, 3),
    (70000, 2, 2, 1, 5), (70000, 2, 2, 5, 5), (2, 8, 8, 1, 300000), (1, 8, 8, 2, 262144),
    (16, 8, 8, 1, 300000), (8, 8, 8, 2, 262145),
])
def test_dimg_plan_grid_covers_every_point_and_image(N, H, W, C, P):
    """Staged: the cluster's blocks tile [0, P) in runs of a multiple of 4
    points, no block wholly past P, and the grid rows, looping in steps of the row
    count, reach every image, N beyond the grid's 65535 rows included.
    Global: its lanes cover every (image, point) pair."""
    plan = point_sample_cuda.dimg_launch_plan(N, H, W, C, P, 0, 0, SMS, OPTIN)
    if plan.kernel == "staged":
        per = plan.points_per_block
        assert per % 4 == 0
        assert plan.cluster * per >= P > (plan.cluster - 1) * per
        assert plan.grid == (plan.cluster, min(N, point_sample_cuda.GRID_ROWS))
        assert -(-N // plan.grid[1]) * plan.grid[1] >= N
    else:
        blocks, rows = plan.grid
        assert rows == 1 and plan.cluster == 1 and plan.points_per_block == 0
        assert blocks * plan.threads >= (N * P) << plan.log2_group > (blocks - 1) * plan.threads
        assert plan.log2_group == point_sample_cuda._log2_group(C)


@pytest.mark.parametrize("N,cluster", [(120, 2), (132, 2), (133, 1), (67, 2), (66, 4),
                                       (60, 4), (8, 4), (300, 1), (70000, 1)])
def test_dimg_cluster_fills_the_sms(N, cluster):
    """Blocks per image: the most of 1, 2 and 4 whose 1024-thread blocks
    fit one wave of the card's 132 SMs at two an SM (the training shape's
    120 images: two blocks each), fewer where the points would leave a
    block with none."""
    assert point_sample_cuda.dimg_cluster(N, 12544, SMS) == cluster
    assert point_sample_cuda.dimg_cluster(N, 5, SMS) == min(cluster, 2)
    assert point_sample_cuda.dimg_cluster(N, 3, SMS) == 1
    assert point_sample_cuda.dimg_launch_plan(N, 56, 56, 1, 12544, 0, 0, SMS,
                                              OPTIN).cluster == cluster


@pytest.mark.parametrize("N,kernel", [(1, "global"), (4, "global"), (7, "global"),
                                      (8, "staged"), (12, "staged"), (30, "staged")])
def test_dimg_plan_takes_global_below_eight_images(N, kernel):
    """Too few images to fill the card: below 8 images (at 132 SMs) the
    global kernel, whose atomics spread over every SM, was faster than the
    staged one at four blocks an image (scripts/bench_point_bwd_plans.py);
    the two tie at 8."""
    plan = point_sample_cuda.dimg_launch_plan(N, 56, 56, 1, 12544, 0, 0, SMS, OPTIN)
    assert plan.kernel == kernel
    # on a card of twice the SMs, twice the images fill the same share
    twice = point_sample_cuda.dimg_launch_plan(2 * N, 56, 56, 1, 12544, 0, 0, 2 * SMS, OPTIN)
    assert twice.kernel == kernel


@pytest.mark.parametrize("P,C,points_ptr,grad_ptr,vec", [
    (12544, 1, 0, 0, True), (12545, 1, 0, 0, False),  # odd P: the second image's points
    (12546, 3, 0, 0, False),  # P * C not a multiple of 4: an image's gradients misalign
    (12544, 3, 0, 0, True), (12544, 1, 4, 0, False), (12544, 1, 0, 8, False),
])
def test_dimg_plan_vec_only_when_aligned(P, C, points_ptr, grad_ptr, vec):
    """float4 point and gradient loads only where every image's points and
    gradients are 16-byte aligned; otherwise the scalar path."""
    plan = point_sample_cuda.dimg_launch_plan(120, 56, 56, C, P, points_ptr, grad_ptr, SMS,
                                              OPTIN)
    assert plan.kernel == "staged" and plan.vec == vec


@pytest.mark.parametrize("shape", [(120, 56, 56, 1, 12544), (3, 7, 5, 33, 101)])
def test_dimg_plan_args(shape):
    """The C function's int array carries the shape and the plan, in order."""
    plan = point_sample_cuda.dimg_launch_plan(*shape, 0, 0, SMS, OPTIN)
    args = list(point_sample_cuda.dimg_plan_args(*shape, plan))
    assert args == [*shape, point_sample_cuda.DIMG_KERNELS.index(plan.kernel), plan.threads,
                    plan.cluster, plan.points_per_block, *plan.grid, int(plan.vec),
                    plan.smem_bytes, plan.log2_group]


def c_signature(source: str, name: str) -> list:
    """The parameter types of `extern "C" int name(...)` in csrc/<source>, as
    ctypes types: a void pointer (the stream too) is c_void_p, an int c_int,
    an int array POINTER(c_int), a float c_float."""
    import ctypes
    import os
    import re

    from combo_avs_torch.ops import _build

    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    params = [p.strip() for p in
              re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text).group(1).split(",")]
    types = {"int": ctypes.c_int, "const int*": ctypes.POINTER(ctypes.c_int),
             "float": ctypes.c_float}
    return [ctypes.c_void_p if "void*" in p else types[p.rsplit(" ", 1)[0]] for p in params]


@pytest.mark.parametrize("name", sorted(point_sample_cuda._SIGNATURES))
def test_argtypes_match_the_c_signature(name):
    """ctypes passes exactly the C function's arguments: a count or a type
    off would shift the stream into an int (the kernels cannot run here)."""
    source, argtypes = point_sample_cuda._SIGNATURES[name]
    assert argtypes == c_signature(source, name)
