"""K6's plain version (the point gather of the criterion's fallback) against
the JAX package's Pallas kernel on the CPU, and the top-k it stands in for.

`gather_lanes` in interpret mode with HIGHEST precision is exact, so the two
must be equal. The JAX criterion selects the fallback's points with
`approx_max_k`; the port takes the exact `torch.topk`, which meets its
recall target of 0.95 by construction, and off the TPU `approx_max_k`
returns the exact top-k, so both packages agree there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combo_avs_tpu.ops.gather_pallas import gather_lanes
from combo_avs_torch.losses.criterion import stratified_chunk, uncertainty_sampled_points
from combo_avs_torch.ops import gather_cuda
from combo_avs_torch.ops.gather_cuda import gather_points, gather_points_plain
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401 (autouse fixtures)


@pytest.mark.parametrize("shape", [(4, 192, 48), (3, 1000, 513), (2, 7, 600)])
def test_plain_matches_gather_lanes(shape):
    """Exact, with the edge indices 0 and NS - 1 and repeated indices. The
    JAX criterion gathers the x and y rows of the flattened [2G, NS]
    candidates with one index array repeated; the port gathers the [G, NS,
    2] points."""
    G, NS, P = shape
    rng = np.random.RandomState(G)
    src = rng.randn(G, NS, 2).astype(np.float32)
    idx = rng.randint(0, NS, (G, P))
    idx[:, 0], idx[:, -1] = 0, NS - 1
    flat = np.concatenate([src[..., 0], src[..., 1]])
    rows = np.asarray(gather_lanes(jnp.asarray(flat), jnp.asarray(np.concatenate([idx, idx]),
                                                                  jnp.int32),
                                   precision=jax.lax.Precision.HIGHEST, interpret=True))
    want = np.stack([rows[:G], rows[G:]], axis=-1)
    before = gather_cuda.launches
    for index in (torch.from_numpy(idx), torch.from_numpy(idx.astype(np.int32))):
        got = gather_points(torch.from_numpy(src), index)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather_points_plain(torch.from_numpy(src), torch.from_numpy(idx)), want)
    assert gather_cuda.launches == before  # the CPU never launches the kernel


def test_approx_max_k_is_exact_top_k_on_cpu():
    """At the fallback's shape of the tiny training configurations (64
    points: 192 candidates, 48 uncertain), which the stratified chunk does
    not divide, `approx_max_k` on the CPU returns `top_k`'s indices, and so
    do `torch.topk`'s."""
    assert stratified_chunk(192, 48) is None
    x = -np.abs(np.random.RandomState(0).randn(6, 192).astype(np.float32))
    _, approx = jax.lax.approx_max_k(jnp.asarray(x), 48, recall_target=0.95)
    _, exact = jax.lax.top_k(jnp.asarray(x), 48)
    np.testing.assert_array_equal(np.asarray(approx), np.asarray(exact))
    np.testing.assert_array_equal(torch.topk(torch.from_numpy(x), 48).indices.numpy(),
                                  np.asarray(exact))


def test_fallback_on_cpu_is_exact_top_k():
    """On the CPU the fallback keeps the exact top-k and torch.gather: the
    selected coordinates are the candidates of smallest |logit|."""
    rng = np.random.RandomState(1)
    M, num_points = 4, 64
    logits = torch.from_numpy(rng.randn(M, 8, 8).astype(np.float32))
    cand = torch.from_numpy(rng.rand(M, 3 * num_points, 2).astype(np.float32))
    tail = torch.from_numpy(rng.rand(M, num_points // 4, 2).astype(np.float32))
    got = uncertainty_sampled_points(logits, cand, tail, num_points, 0.75)
    assert got.shape == (M, num_points, 2)
    torch.testing.assert_close(got[:, 48:], tail, rtol=0, atol=0)
    from combo_avs_torch.ops.grid_sample import point_sample

    score = point_sample(logits[..., None], cand)[..., 0].abs()
    keep = torch.argsort(score, dim=-1, stable=True)[:, :48]
    want = torch.gather(cand, 1, keep[..., None].expand(-1, -1, 2))
    for m in range(M):  # the same set of points (top-k orders ties its own way)
        a = {tuple(p) for p in got[m, :48].tolist()}
        assert a == {tuple(p) for p in want[m].tolist()}


# (index bytes, index address, output address) -> points a thread: 4 where the index is
# aligned to min(16, 4 x its bytes) and the output to 16, else 1
GATHER_PLANS = {
    "aligned_int64": ((8, 0x7f0000000000, 0x7f0000100000), 4),
    "aligned_int32": ((4, 0x7f0000000000, 0x7f0000100000), 4),
    "index_8_bytes_off": ((8, 0x7f0000000008, 0x7f0000100000), 1),
    "int32_index_8_bytes_off": ((4, 0x7f0000000008, 0x7f0000100000), 1),
    "output_8_bytes_off": ((8, 0x7f0000000000, 0x7f0000100008), 1),
}


@pytest.mark.parametrize("case", sorted(GATHER_PLANS))
def test_gather_launch_plan(case):
    """K6's points a thread are a pure function of the index's element size
    and the two addresses' alignment (the kernel cannot run here)."""
    args, want = GATHER_PLANS[case]
    assert gather_cuda.points_per_thread(*args) == want


def test_cuda_wrappers_refuse_before_any_launch():
    """The kernel's wrappers refuse what they do not take before they build
    or launch anything: CPU tensors (no fallback to the plain version) and
    a floor that does not exist."""
    src = torch.rand((2, 5, 2))
    idx = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_cuda.gather_points_cuda(src, idx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_cuda.gather_floor_cuda(src, idx, "stream")
    with pytest.raises(ValueError, match="'copy' is not"):
        gather_cuda.gather_floor_cuda(src, idx, "copy")


@pytest.mark.parametrize("name", sorted(gather_cuda.ARGTYPES))
def test_argtypes_match_the_c_signature(name):
    """ctypes passes exactly the C functions' arguments, the gather's and
    its floors' (a count or a type off would shift the stream into an
    int)."""
    from tests.test_torch_point_sample import c_signature

    assert gather_cuda.ARGTYPES[name] == c_signature(gather_cuda.SOURCE, name)
