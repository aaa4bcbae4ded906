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


@pytest.mark.parametrize("shape", [(2, 8, 16, 1, 90), (3, 16, 8, 5, 61)], ids=["C1", "C5"])
def test_plain_matches_jax_fp64(shape):
    """The same function in float64: values and both gradients to 1e-12."""
    N, H, W, C, P = shape
    feat, pts = _inputs(N, H, W, C, P, seed=C)
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


@pytest.mark.parametrize("shape", [(2, 8, 16, 1, 700), (3, 16, 8, 3, 300)], ids=["C1", "C3"])
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
    """The kernels give each point the smallest power of two of lanes that
    covers its channels, at most a warp."""
    assert point_sample_cuda._log2_group(C) == group
