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
