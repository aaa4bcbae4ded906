"""The PyTorch port's optimizer (`train/optim.py`) against the JAX package's
optax chain (`combo_avs_tpu/train/optim.py::build_optimizer`) on the CPU.

Port parameter names are mapped to JAX leaves through
`convert_combo_checkpoint` applied to a state dict of distinct marker values:
each JAX leaf then holds the markers of the port tensors it was made from."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from combo_avs_tpu.config import setup_cfg
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.optim import build_optimizer
from combo_avs_tpu.train.optim import warmup_poly_schedule as jax_warmup_poly_schedule
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.train.optim import (Optimizer, clip_by_global_norm_, param_groups,
                                         warmup_poly_schedule)
from tests.test_torch_losses import S4_CONFIG
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)

# loud, pairwise-distinct decays (as tests/test_optim_oracle.py): one
# misclassified tensor changes its update by a large factor
WD, WD_NORM, WD_EMBED, BACKBONE_MULT = 2.0, 5.0, 9.0, 0.1
BASE_LR, MAX_ITER, WARMUP_ITERS, WARMUP_FACTOR, CLIP = 0.05, 100, 2, 0.01, 0.01


def _cfg(**solver):
    cfg = setup_cfg(S4_CONFIG, freeze=False)
    for k, v in solver.items():
        cfg.SOLVER[k] = v
    return cfg


def _fields():
    """The tiny flagship's constructor arguments, as the JAX model has them."""
    return _port_kwargs(graft._flagship_model(tiny=True))


@pytest.fixture(scope="module")
def tiny():
    """The tiny flagship in the port (fp64, seeded init), its JAX params, and
    the map from each JAX param leaf to the port tensors it holds."""
    fields = _fields()
    port = init_weights(MaskFormer(**fields, device="cpu"), seed=0).double()
    kw = dict(dec_layers=fields["dec_layers"], enc_layers=fields["enc_layers"])
    sd = port.state_dict()
    names = list(sd)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          convert_combo_checkpoint({k: v.numpy() for k, v in sd.items()},
                                                   **kw)["params"])
    markers = convert_combo_checkpoint(
        {k: np.full(v.shape, i + 1, np.float64) for i, (k, v) in enumerate(sd.items())},
        **kw)["params"]
    leaf_names = {}
    for path, m in jax.tree_util.tree_flatten_with_path(markers)[0]:
        ids = np.unique(np.asarray(m))
        assert np.all(ids == np.round(ids)) and ids.min() >= 1, path  # markers only
        leaf_names[jax.tree_util.keystr(path)] = [names[int(i) - 1] for i in ids]
    return port, params, leaf_names, kw


def _apply(chain, grads, state, params):
    updates, state = chain.update(grads, state, params)
    return optax.apply_updates(params, updates), state


def _jax_leaf_hyperparams(params, cfg):
    """(lr multiplier, weight decay) per JAX leaf, read off build_optimizer's
    chain: with the clip off and a step-0 learning rate `lr`, a unit gradient
    at zero weights moves a leaf by -lr * mult * 1/(1 + eps), and a zero
    gradient at unit weights by -lr * mult * wd."""
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False
    opt, schedule = build_optimizer(cfg, params)
    lr = float(schedule(0))
    ones = jax.tree.map(jnp.ones_like, params)
    zeros = jax.tree.map(jnp.zeros_like, params)
    update = jax.jit(opt.update)  # one dispatch instead of one per leaf and op
    u1, _ = update(ones, opt.init(zeros), zeros)
    u2, _ = update(zeros, opt.init(ones), ones)
    out = {}
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(u1)[0],
                                 jax.tree_util.tree_flatten_with_path(u2)[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert np.ptp(a) == 0 and np.ptp(b) == 0  # one value per leaf
        mult = float(-a.flat[0] / lr * (1 + 1e-8))
        out[jax.tree_util.keystr(path)] = (mult, float(-b.flat[0] / lr / mult) if mult else 0.0)
    return out


def test_param_groups_match_jax(tiny):
    """Every trainable port parameter's (lr multiplier, weight decay) equals
    the one build_optimizer gives the JAX leaf it converts to; the frozen
    VGGish tower gets no group in the port and a zero multiplier in JAX."""
    port, params, leaf_names, _ = tiny
    with jax.enable_x64(True):
        want = _jax_leaf_hyperparams(params, _cfg(WEIGHT_DECAY=WD, WEIGHT_DECAY_NORM=WD_NORM,
                                                  WEIGHT_DECAY_EMBED=WD_EMBED,
                                                  BACKBONE_MULTIPLIER=BACKBONE_MULT))
    groups = {n: (g["lr_multiplier"], g["weight_decay"])
              for g in param_groups(port, WD, WD_NORM, WD_EMBED, BACKBONE_MULT)
              for n in g["names"]}
    trainable = {n for n, p in port.named_parameters() if not n.startswith("audio_backbone.")}
    assert set(groups) == trainable
    kinds = set()
    for leaf, names in leaf_names.items():
        mult, wd = want[leaf]
        for n in names:
            if n.startswith("audio_backbone."):
                assert mult == 0.0, leaf
            elif n in groups:
                assert groups[n][0] == pytest.approx(mult, rel=1e-6), (n, leaf)
                assert groups[n][1] == pytest.approx(wd, rel=1e-6), (n, leaf)
                kinds.add(groups[n])
    # every rule was exercised: default, norm and embedding decay, backbone lr
    assert {(1.0, WD), (1.0, WD_NORM), (1.0, WD_EMBED), (BACKBONE_MULT, WD)} <= kinds
    assert {n for names in leaf_names.values() for n in names} >= trainable


def test_optimizer_defaults_are_the_s4_recipe(tiny):
    port = tiny[0]
    s = setup_cfg(S4_CONFIG).SOLVER
    opt = Optimizer(port)
    assert opt.clip_value == s.CLIP_GRADIENTS.CLIP_VALUE and s.CLIP_GRADIENTS.ENABLED
    assert {(g["lr_multiplier"], g["weight_decay"]) for g in opt.groups} <= {
        (1.0, s.WEIGHT_DECAY), (1.0, s.WEIGHT_DECAY_NORM), (1.0, s.WEIGHT_DECAY_EMBED),
        (s.BACKBONE_MULTIPLIER, s.WEIGHT_DECAY), (s.BACKBONE_MULTIPLIER, s.WEIGHT_DECAY_NORM)}
    want = jax_warmup_poly_schedule(s.BASE_LR, s.MAX_ITER, s.WARMUP_ITERS, s.WARMUP_FACTOR,
                                    s.POLY_LR_POWER)
    for k in (0, 1, 45000, 60000, 90000, 95000):  # where float32 resolves the poly term
        assert opt.schedule(k) == pytest.approx(float(want(k)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("ending", [0.0, 0.3])
def test_schedule_matches_jax(ending):
    # the optax schedule computes in float32: agreement at that resolution
    want = jax_warmup_poly_schedule(BASE_LR, MAX_ITER, WARMUP_ITERS, WARMUP_FACTOR, 0.9, ending)
    got = warmup_poly_schedule(BASE_LR, MAX_ITER, WARMUP_ITERS, WARMUP_FACTOR, 0.9, ending)
    for k in (0, 1, 2, 3, 50, 99, 100, 150):
        assert got(k) == pytest.approx(float(want(k)), rel=1e-6, abs=1e-12), k


@pytest.mark.parametrize("scale", [1e-4, 1.0], ids=["below", "above"])
def test_clip_matches_optax(scale):
    """g * min(1, c / ||g||) with no epsilon, below and above the limit."""
    rng = np.random.RandomState(1)
    grads = [rng.randn(*s) * scale for s in ((3, 4), (7,), (2, 2, 2))]
    with jax.enable_x64(True):
        want, _ = optax.clip_by_global_norm(CLIP).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, CLIP)
    assert float(norm) == pytest.approx(np.sqrt(sum((g ** 2).sum() for g in grads)), rel=1e-14)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=0)


def test_three_step_adamw_twin_matches_optax(tiny):
    """Three clipped AdamW steps of the port's Optimizer and of the optax
    chain on identical weights and identical gradients (warmup crossed in
    the run, backbone multiplier, all three decay kinds). The JAX schedule
    computes in float32 (relative error up to 2^-24), everything else is
    float64 on both sides: the weight deltas agree to 1e-6 of each leaf's
    largest delta."""
    _, params, _, kw = tiny
    # a fresh copy of the same weights: this test updates them
    net = init_weights(MaskFormer(**_fields(), device="cpu"), seed=0).double()
    opt = Optimizer(net, base_lr=BASE_LR, max_iter=MAX_ITER, warmup_iters=WARMUP_ITERS,
                    warmup_factor=WARMUP_FACTOR, weight_decay=WD, weight_decay_norm=WD_NORM,
                    weight_decay_embed=WD_EMBED, backbone_multiplier=BACKBONE_MULT,
                    clip_value=CLIP)
    in_groups = {id(p) for g in opt.groups for p in g["params"]}
    shapes = {n: (p.shape, id(p) in in_groups) for n, p in net.named_parameters()}
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}

    def grad_steps():
        """The three steps' gradients, drawn anew for each side from one seed
        (one step's worth held at a time: the tiny flagship's 16.8 M-weight
        audio layer makes each copy 150 MB in float64)."""
        rng = np.random.RandomState(5)
        for _ in range(3):
            yield {n: rng.randn(*shape) * 0.1 if trained else np.zeros(shape)
                   for n, (shape, trained) in shapes.items()}

    for g in grad_steps():
        opt.zero_grad()
        for n, p in net.named_parameters():
            if id(p) in in_groups:
                p.grad = torch.from_numpy(g[n])
        opt.step()
    got = convert_combo_checkpoint(
        {k: (v - sd0[k]).numpy() for k, v in net.state_dict().items()}, **kw)["params"]
    buffers = {n: np.zeros(b.shape) for n, b in net.named_buffers()}
    del opt, net, sd0, g  # the port's side is done: give its weights and moments back

    with jax.enable_x64(True):
        cfg = _cfg(BASE_LR=BASE_LR, MAX_ITER=MAX_ITER, WARMUP_ITERS=WARMUP_ITERS,
                   WARMUP_FACTOR=WARMUP_FACTOR, WEIGHT_DECAY=WD, WEIGHT_DECAY_NORM=WD_NORM,
                   WEIGHT_DECAY_EMBED=WD_EMBED, BACKBONE_MULTIPLIER=BACKBONE_MULT)
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = CLIP
        chain, _ = build_optimizer(cfg, params)
        update = jax.jit(lambda g, st, p: _apply(chain, g, st, p))
        jp, state = params, chain.init(params)
        for g in grad_steps():
            jg = jax.tree.map(jnp.asarray,
                              convert_combo_checkpoint({**g, **buffers}, **kw)["params"])
            jp, state = update(jg, state, jp)
        want = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), jp, params)
    moved = 0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * scale + 1e-300,
                                   err_msg=jax.tree_util.keystr(path))
        moved += scale > 0
    assert moved > 50

