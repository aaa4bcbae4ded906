"""The port's semantic inference (the eval tail that K7 fuses) against the
JAX package on the CPU.

`seminf_cuda.semantic_inference_plain` is K7's plain version and the CPU
path of `meta_arch.semantic_inference`. At float64 it is held to 1e-9
against the same composition in JAX (softmax, `jax.image.resize` bilinear,
sigmoid, the class contraction, the temporal mask) at float64: the JAX
package's own `meta_arch.semantic_inference` and `seminf_pallas` take the
class logits to float32 first, so they are held at float32 instead, within
1e-6 and 1e-5 of max |output| (the order of the sums differs; the Pallas
kernel also interpolates through resize matrices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combo_avs_tpu.models.meta_arch import semantic_inference as jax_semantic_inference
from combo_avs_tpu.ops.seminf_pallas import seminf_pallas
from combo_avs_torch.models.meta_arch import semantic_inference
from combo_avs_torch.ops import seminf_cuda
from combo_avs_torch.ops.seminf_cuda import semantic_inference_plain
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401 (autouse fixtures)

N, Q, C, h, w = 3, 6, 2, 8, 8
SIZES = [(32, 32), (20, 28), (8, 8)]  # x4, a ratio that is not an integer, same size


def _inputs(seed, c=C):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, Q, c + 1), rng.randn(N, Q, h, w) * 4,
            (rng.rand(N) > 0.3).astype(np.float64))


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=["x4", "ragged", "same"])
def test_plain_matches_jax_composition_fp64(size, temporal):
    logits, mask, tm = _inputs(0)
    tm = tm if temporal else None
    with jax.enable_x64(True):
        cls = jax.nn.softmax(jnp.asarray(logits), axis=-1)[..., :-1]
        up = jax.image.resize(jnp.asarray(mask), (N, Q, *size), "bilinear")
        want = jnp.einsum("nqc,nqhw->nchw", cls, jax.nn.sigmoid(up))
        if tm is not None:
            want = want * jnp.asarray(tm)[:, None, None, None]
        want = np.asarray(want)
    got = semantic_inference_plain(torch.from_numpy(_softmax(logits)[..., :-1]),
                                   torch.from_numpy(mask), size,
                                   None if tm is None else torch.from_numpy(tm))
    assert got.dtype == torch.float64 and got.shape == (N, C, *size)
    _close(got.numpy(), want, 1e-9)


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=["x4", "ragged", "same"])
def test_semantic_inference_matches_jax_fp32(size, temporal):
    """meta_arch.semantic_inference, port against JAX, float32 in and out;
    on the CPU the port never launches K7."""
    logits, mask, tm = (a.astype(np.float32) for a in _inputs(1))
    tm = tm if temporal else None
    want = np.asarray(jax_semantic_inference(jnp.asarray(logits), jnp.asarray(mask), size,
                                             None if tm is None else jnp.asarray(tm)))
    before = seminf_cuda.launches
    got = semantic_inference(torch.from_numpy(logits), torch.from_numpy(mask), size,
                             None if tm is None else torch.from_numpy(tm))
    assert seminf_cuda.launches == before
    assert got.dtype == torch.float32 and got.shape == (N, C, *size)
    _close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("c", [1, 2, 5])
def test_plain_matches_seminf_pallas_interpret(c):
    """K7's plain version against the TPU kernel in interpret mode (its
    shape gate wants h % 8 == 0 and an upsampling size)."""
    logits, mask, _ = (a.astype(np.float32) for a in _inputs(2, c))
    cls = _softmax(logits)[..., :-1].astype(np.float32)
    want = np.asarray(seminf_pallas(jnp.asarray(cls), jnp.asarray(mask), (32, 24),
                                    interpret=True))
    got = semantic_inference_plain(torch.from_numpy(cls), torch.from_numpy(mask), (32, 24))
    _close(got.numpy(), want, 1e-5)


def test_kernel_gate():
    """Which calls K7 takes (`meta_arch.semantic_inference` asks this for a
    CUDA tensor): at most 8 classes and an upsampling or same size."""
    assert seminf_cuda.kernel_takes(2, (56, 56), (224, 224))
    assert seminf_cuda.kernel_takes(8, (56, 56), (56, 56))
    assert not seminf_cuda.kernel_takes(71, (56, 56), (224, 224))  # AVSS keeps the plain form
    assert not seminf_cuda.kernel_takes(2, (56, 56), (28, 224))  # downsampling
    assert not seminf_cuda.kernel_takes(2, (56, 56), None)
    with pytest.raises(ValueError, match="CUDA"):
        seminf_cuda.seminf_cuda(torch.zeros(1, 2, 2), torch.zeros(1, 2, 4, 4), (8, 8))


@pytest.mark.parametrize("h,w,H,W,kernel,patch", [
    (56, 56, 224, 224, "patch", 4),  # the eval tail's 4x
    (56, 56, 168, 168, "patch", 2),  # 3x: the largest side within the ratio
    (56, 56, 112, 224, "patch", 2),
    (7, 6, 14, 48, "patch", 2),
    (28, 28, 56, 56, "patch", 2),  # 2x: the smallest ratio a patch takes
    (3, 4, 9, 8, "patch", 2),
    (56, 56, 448, 448, "patch", 4),
    (6, 6, 6, 6, "pixel", 1),  # the same size: a ratio of 1
    (3, 4, 9, 4, "pixel", 1),  # ratios 3 and 1
    (56, 56, 56, 224, "pixel", 1),  # ratios 1 and 4
    (5, 9, 13, 31, "pixel", 1),  # ragged
    (56, 56, 225, 224, "pixel", 1),  # one row more than 4x
    (56, 56, 384, 384, "pixel", 1),  # a TTA size: 384 / 56 is not an integer
    (8, 8, 20, 28, "pixel", 1),
])
def test_launch_plan_takes_patch_exactly_at_integer_ratios(h, w, H, W, kernel, patch):
    """K7 computes patches exactly when H / h and W / w are integers of at
    least 2, with the largest square patch within both ratios; any other
    upsampling takes the pixel kernel, one thread per output pixel."""
    plan = seminf_cuda.launch_plan(20, 100, 2, h, w, H, W)
    assert (plan.kernel, plan.patch) == (kernel, patch)
    assert plan.smem_bytes == 100 * 2 * 4
    if kernel == "pixel":
        assert plan == seminf_cuda.pixel_plan(100, 2, H, W)
        assert plan.blocks_per_frame * plan.threads >= H * W


@pytest.mark.parametrize("C,patch", [(1, 4), (2, 4), (4, 4), (5, 2), (8, 2)])
def test_launch_plan_patch_side_by_classes(C, patch):
    """Above four classes a 4 x 4 patch's accumulators would spill: 2 x 2."""
    assert seminf_cuda.launch_plan(20, 100, C, 56, 56, 224, 224).patch == patch


@pytest.mark.parametrize("h,w,H,W,side", [(56, 56, 224, 224, 4), (56, 56, 168, 168, 2),
                                          (7, 6, 14, 48, 2), (3, 4, 9, 8, 2),
                                          (5, 5, 40, 40, 4)])
def test_patch_grid_covers_every_pixel_once(h, w, H, W, side):
    """The patches of a frame tile its H x W output: every pixel falls in
    exactly one patch's in-band rows and columns, and the plan's blocks
    cover every patch."""
    rows, cols = seminf_cuda.patch_grid(h, w, H, W, side)
    ry, rx = H // h, W // w
    py, px = -(-ry // side), -(-rx // side)

    def span(index, per, r, n):
        band, sub = divmod(index, per)
        lo = r * (band - 1) + r // 2 + sub * side
        return range(max(lo, 0), min(lo + side, r * band + r // 2, n))

    ys = [y for pr in range(rows) for y in span(pr, py, ry, H)]
    xs = [x for pc in range(cols) for x in span(pc, px, rx, W)]
    assert sorted(ys) == list(range(H)) and sorted(xs) == list(range(W))
    plan = seminf_cuda.launch_plan(2, 3, 2, h, w, H, W)
    assert plan.patch == side and plan.blocks_per_frame * plan.threads >= rows * cols


def test_argtypes_match_the_c_signature():
    """ctypes passes exactly the C function's arguments: a count or a type
    off would shift the stream into an int (the kernel cannot run here)."""
    from tests.test_torch_point_sample import c_signature

    assert seminf_cuda.ARGTYPES == c_signature(seminf_cuda.SOURCE, "seminf_fwd")


@pytest.mark.parametrize("h,w,H,W,code,patch", [(56, 56, 224, 224, 1, 4),
                                                 (5, 9, 13, 31, 0, 1)])
def test_plan_args(h, w, H, W, code, patch):
    """The C function's int array carries the shape and the plan, in order."""
    plan = seminf_cuda.launch_plan(20, 100, 2, h, w, H, W)
    assert list(seminf_cuda.plan_args(20, 100, 2, h, w, H, W, True, plan)) == [
        20, 100, 2, h, w, H, W, 1, code, plan.threads, patch, plan.blocks_per_frame, 800]
