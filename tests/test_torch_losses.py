"""The PyTorch port's training losses against the JAX package on the CPU:
the small-row assignment solver (`ops.lsap`), the Hungarian matcher and the
set criterion (`losses/`), and the stratified uncertain-point selection.

Every random draw of the JAX criterion (the matcher's shared points, the 3x
oversampled candidates and the random tails) is recovered from its key, as
tests/test_criterion_oracle.py does, and injected into the port's
criterion, so both sides score the same points. Inputs are made with numpy
from a seed and handed to both frameworks."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from combo_avs_tpu.losses.criterion import SetCriterion as JaxSetCriterion
from combo_avs_tpu.losses.criterion import _stratified_chunk as jax_stratified_chunk
from combo_avs_tpu.losses.criterion import (
    _stratified_uncertain_coords as jax_stratified_uncertain_coords)
from combo_avs_tpu.losses.matcher import HungarianMatcher as JaxHungarianMatcher
from combo_avs_tpu.ops.lsap import solve_lsap_small
from combo_avs_torch.losses.criterion import (
    SetCriterion, build_weight_dict, stratified_chunk, stratified_uncertain_coords,
    total_loss)
from combo_avs_torch.losses.matcher import HungarianMatcher
from combo_avs_torch.ops.lsap import solve_lsap_batch
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401 (autouse fixtures)

# small point counts: 64 PointRend points (192 candidates, 48 uncertain, 16
# random), 128 matcher points
NPTS, OS, ISR, MPTS = 64, 3.0, 0.75, 128
S4_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "combo_avs_tpu", "configs", "avs_s4", "COMBO_R50_bs8_90k.yaml")


def jax_draws(key, n_layers, N, K, num_points=NPTS, matcher_points=MPTS,
              oversample=OS, importance=ISR):
    """The JAX criterion's per-layer draws from `key`, as numpy arrays:
    (matcher points [N, MP, 2], candidates [N*K, 3P, 2], tail [N*K, P/4, 2]),
    the final layer first. Mirrors SetCriterion.__call__'s key split."""
    keys = jax.random.split(key, 2 * n_layers)
    M = N * K
    n_sampled = int(num_points * oversample)
    n_random = num_points - int(num_points * importance)
    out = []
    for j in range(n_layers):
        k1, k2 = jax.random.split(keys[2 * j + 1])
        out.append(tuple(np.array(a) for a in (
            jax.random.uniform(keys[2 * j], (N, matcher_points, 2)),
            jax.random.uniform(k1, (M, n_sampled, 2)),
            jax.random.uniform(k2, (M, n_random, 2)))))
    return out


# ---------------------------------------------------------------- LSAP
@pytest.mark.parametrize("R", [1, 2, 3, 5])
def test_lsap_optimal_and_matches_jax(R):
    """The optimal total of scipy's solver, and the same assignment as JAX's
    solve_lsap_small (random float costs have one optimum)."""
    rng = np.random.RandomState(R)
    cost = rng.rand(16, R, 9).astype(np.float32)
    cost[:4] = np.round(cost[:4] * 4) / 4  # some ties in the first frames
    got = solve_lsap_batch(torch.from_numpy(cost)).numpy()
    assert got.shape == (16, R) and got.dtype == np.int64
    want = np.stack([np.asarray(solve_lsap_small(jnp.asarray(c))) for c in cost])
    for i, c in enumerate(cost):
        assert len(set(got[i])) == R  # a column at most once
        rows, cols = linear_sum_assignment(c)
        best = c[rows, cols].sum()
        assert abs(c[np.arange(R), got[i]].sum() - best) <= 1e-6
        if i >= 4:
            np.testing.assert_array_equal(got[i], want[i])


def test_lsap_refuses_more_than_five_rows():
    """The closed form refuses more than five rows: above them (AVSS's 12
    slots would be 12^12 tuples) the dispatch hands the batch to the
    Jonker-Volgenant solver, as the JAX package's `solve_lsap_batch` does;
    and more rows than columns raise."""
    from unittest import mock

    from combo_avs_torch.ops import lsap

    with mock.patch.object(lsap, "solve_lsap_small", side_effect=AssertionError("closed form")):
        got = solve_lsap_batch(torch.zeros(1, 6, 10))
    assert sorted(got[0].tolist()) == list(range(6))  # every column costs 0: distinct ones
    with pytest.raises(ValueError, match="R <= C"):
        solve_lsap_batch(torch.zeros(1, 6, 5))


# ---------------------------------------------------------------- matcher + criterion
N_FRAMES, Q, NCLS, K, h, HGT, LAYERS = 5, 8, 2, 3, 16, 32, 3


def _problem(seed, valid_counts):
    """Random fp64 outputs for LAYERS decoder outputs and padded targets;
    valid_counts[i] valid slots in frame i, packed first."""
    rng = np.random.RandomState(seed)
    out = {
        "pred_logits": rng.randn(N_FRAMES, Q, NCLS + 1) * 2.0,
        "pred_masks": rng.randn(N_FRAMES, Q, h, h) * 2.0,
        "aux_outputs": [{"pred_logits": rng.randn(N_FRAMES, Q, NCLS + 1) * 2.0,
                         "pred_masks": rng.randn(N_FRAMES, Q, h, h) * 2.0}
                        for _ in range(LAYERS - 1)],
        "middles_attn_mask": [rng.randn(N_FRAMES, Q, h * h) for _ in range(LAYERS - 1)],
    }
    valid = np.zeros((N_FRAMES, K), bool)
    for i, c in enumerate(valid_counts):
        valid[i, :c] = True
    targets = {"labels": rng.randint(0, NCLS, (N_FRAMES, K)).astype(np.int32),
               "masks": rng.rand(N_FRAMES, K, HGT, HGT) > 0.6, "valid": valid}
    return out, targets


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


REGIMES = {
    # S4: the first frame of the video only, two valid slots
    "s4": ([2, 3, 1, 0, 3], np.array([1.0, 0, 0, 0, 0])),
    # every frame weighted, ragged slots, one empty frame
    "all_frames": ([2, 3, 1, 0, 3], np.ones(N_FRAMES)),
}


@pytest.fixture(scope="module", params=sorted(REGIMES))
def regime(request):
    """JAX losses, per-layer assignments and draws, computed once."""
    counts, fw = REGIMES[request.param]
    out, targets = _problem(seed=len(request.param), valid_counts=counts)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        crit = JaxSetCriterion(num_classes=NCLS, matcher=JaxHungarianMatcher(num_points=MPTS),
                               num_points=NPTS, oversample_ratio=OS,
                               importance_sample_ratio=ISR, cosine_n_frame=N_FRAMES,
                               exact_topk=True)
        jtgt = {k: jnp.asarray(v) for k, v in targets.items()}
        losses = {k: float(v) for k, v in crit(key, jax.tree.map(jnp.asarray, out), jtgt,
                                               frame_weight=jnp.asarray(fw)).items()}
        draws = jax_draws(key, LAYERS, N_FRAMES, K)
        valid = jtgt["valid"] & (jnp.asarray(fw)[:, None] > 0)
        layers = [out] + out["aux_outputs"]
        assigns = [np.asarray(crit.matcher(jax.random.split(key, 2 * LAYERS)[2 * j],
                                           jnp.asarray(l["pred_logits"]),
                                           jnp.asarray(l["pred_masks"]), jtgt["labels"],
                                           jtgt["masks"], valid))
                   for j, l in enumerate(layers)]
    return dict(out=out, targets=targets, fw=fw, losses=losses, draws=draws,
                assigns=assigns, valid=np.array(valid))


def _port_criterion():
    return SetCriterion(num_classes=NCLS, matcher=HungarianMatcher(num_points=MPTS),
                        num_points=NPTS, oversample_ratio=OS, importance_sample_ratio=ISR,
                        cosine_n_frame=N_FRAMES)


def test_matcher_assignments_match_jax(regime):
    matcher = _port_criterion().matcher
    t = _to_torch(regime["targets"])
    layers = [regime["out"]] + regime["out"]["aux_outputs"]
    for j, layer in enumerate(layers):
        got = matcher(torch.from_numpy(regime["draws"][j][0]),
                      torch.from_numpy(layer["pred_logits"]), torch.from_numpy(layer["pred_masks"]),
                      t["labels"], t["masks"], torch.from_numpy(regime["valid"]))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), regime["assigns"][j])
        assert (got.numpy()[~regime["valid"]] == -1).all()


def test_cost_matrix_matches_jax_fp64(regime):
    """The matching cost itself, before assignment: fp64 to 1e-12."""
    t = _to_torch(regime["targets"])
    pts = regime["draws"][0][0]
    got = _port_criterion().matcher.cost_matrix(
        torch.from_numpy(pts), torch.from_numpy(regime["out"]["pred_logits"]),
        torch.from_numpy(regime["out"]["pred_masks"]), t["labels"], t["masks"],
        torch.from_numpy(regime["valid"]))
    with jax.enable_x64(True):
        jm = JaxHungarianMatcher(num_points=MPTS)
        # the JAX matcher draws its points from the key it is given: the same
        # key as the criterion's first layer
        want = np.asarray(jm.cost_matrix(
            jax.random.split(jax.random.PRNGKey(7), 2 * LAYERS)[0],
            jnp.asarray(regime["out"]["pred_logits"]), jnp.asarray(regime["out"]["pred_masks"]),
            jnp.asarray(regime["targets"]["labels"]), jnp.asarray(regime["targets"]["masks"]),
            jnp.asarray(regime["valid"])))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_criterion_losses_match_jax_fp64(regime):
    """Every named loss and the weighted total, with the JAX draws injected:
    fp64 to 1e-9 relative."""
    losses = _port_criterion()(_to_torch(regime["out"]), _to_torch(regime["targets"]),
                               frame_weight=torch.from_numpy(regime["fw"]),
                               draws=[tuple(map(torch.from_numpy, d)) for d in regime["draws"]])
    want = regime["losses"]
    assert set(losses) == set(want)
    for k, v in losses.items():
        assert v.dtype == torch.float64, k
        assert abs(float(v) - want[k]) <= 1e-9 * max(1.0, abs(want[k])), (k, float(v), want[k])
    wd = build_weight_dict(dec_layers=LAYERS)
    tot = float(total_loss(losses, wd))
    assert abs(tot - sum(want[k] * wd[k] for k in want)) <= 1e-9 * abs(tot)


def test_criterion_draws_from_generator():
    """Without injected draws the criterion draws from the generator it is
    given: the same seed gives the same losses, another seed others."""
    out, targets = _problem(seed=3, valid_counts=[1, 2, 3, 1, 2])
    tout, ttgt = _to_torch(out), _to_torch(targets)
    crit = _port_criterion()

    def run(seed):
        return crit(tout, ttgt, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if k.startswith("loss_mask"))
    with pytest.raises(ValueError, match="generator"):
        crit(tout, ttgt)


def test_s4_defaults_match_jax_config():
    """The port's defaults are the S4 recipe's values: the loss weights, the
    matcher's costs and points, and the criterion's settings."""
    from combo_avs_tpu.config import setup_cfg
    from combo_avs_tpu.losses.criterion import build_weight_dict as jax_build_weight_dict
    from combo_avs_tpu.train.trainer import build_criterion

    cfg = setup_cfg(S4_CONFIG)
    assert build_weight_dict() == jax_build_weight_dict(cfg)
    want, got = build_criterion(cfg), SetCriterion()
    for name in ("num_classes", "eos_coef", "num_points", "oversample_ratio",
                 "importance_sample_ratio", "cosine_n_frame", "exact_topk"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("cost_class", "cost_mask", "cost_dice", "num_points"):
        assert getattr(got.matcher, name) == getattr(want.matcher, name), name


# ---------------------------------------------------------------- stratified selection
def test_stratified_selection_matches_jax():
    """The accelerator's uncertain-point selection: each 256-candidate chunk
    sorted by |logit|, its quota kept, on identical logits and coords. The
    production shapes (37632 candidates, 9408 uncertain) divide."""
    assert stratified_chunk(37632, 9408) == jax_stratified_chunk(37632, 9408) == (256, 64)
    assert stratified_chunk(192, 48) == jax_stratified_chunk(192, 48)
    assert stratified_chunk(300, 75) is None and jax_stratified_chunk(300, 75) is None
    rng = np.random.RandomState(11)
    logits = rng.randn(6, 1024).astype(np.float32)
    coords = rng.rand(6, 1024, 2).astype(np.float32)
    want = np.asarray(jax_stratified_uncertain_coords(jnp.asarray(logits), jnp.asarray(coords),
                                                      256, 64))
    got = stratified_uncertain_coords(torch.from_numpy(logits), torch.from_numpy(coords), 256, 64)
    assert got.shape == (6, 256, 2)
    np.testing.assert_array_equal(got.numpy(), want)
