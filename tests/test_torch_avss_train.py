"""The port's AVSS training step against the JAX package on the CPU, on the
tiny flagship with AVSS's 71 classes, 16 queries and one decoder layer: 1
video x 5 frames x 32^2 of v1s (the first frame annotated and weighted),
K = 12 target slots, so the
matcher solves 12-row problems with the Jonker-Volgenant solver on both
sides.

* float64: the training losses and their gradient with respect to every
  parameter, as tests/test_torch_train.py holds the S4 step;
* the bf16 AMP regime: JAX's `make_train_step(amp=True)` (its losses, and
  its gradient, read back from one SGD step of rate 1) against the port's
  AMP forward and backward on the same weights and draws, within bf16
  bounds; and the port's `make_train_step(amp=True)` keeps float32 master
  weights.

Weights come from the port's seeded init and go through
`convert_combo_checkpoint` into the JAX model; gradients take the same road.
The JAX criterion's random draws are recovered from its key and injected
into the port's. Dropout is off on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import __graft_entry__ as graft
from combo_avs_tpu.losses.criterion import SetCriterion as JaxSetCriterion
from combo_avs_tpu.losses.criterion import total_loss as jax_total_loss
from combo_avs_tpu.losses.matcher import HungarianMatcher as JaxHungarianMatcher
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.train_step import TrainState
from combo_avs_tpu.train.train_step import make_train_step as jax_make_train_step
from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict, total_loss
from combo_avs_torch.losses.matcher import HungarianMatcher
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.train.optim import Optimizer
from combo_avs_torch.train.train_step import compute_losses, make_train_step
from tests.test_torch_losses import ISR, MPTS, NPTS, OS, jax_draws
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)
from tests.test_torch_train import GRAD_FLOOR, GRAD_RL2, LOSS_RTOL

B, T, S, K, NCLS = 1, 5, 32, 12, 71
# bf16 AMP, two frameworks: each bf16 rounding is 2^-9 relative, and the two
# round different intermediates (XLA's and torch's CPU kernels) through two
# towers, the pixel decoder and the decoder; the criterion then runs in fp32
# on outputs that carry that noise. On this model and batch, each
# framework's AMP step lies this far from the fp32 one (losses 3.3e-3 and
# 3.9e-3 relative, the whole gradient 0.086 and 0.133 rel-L2: the port's and
# JAX's), and the two AMP steps 1.8e-3 and 0.119 apart. The bounds: each
# loss within 1e-2 relative, the whole gradient within 0.2 rel-L2, 1.5x
# JAX's own distance from fp32; the port's AMP gradient is held to the same
# 0.2 from its fp32 one, which a gradient lost on the way to the fp32
# weights would break
AMP_LOSS_RTOL, AMP_GRAD_RL2 = 1e-2, 0.2


def _models():
    jm = graft._flagship_model(tiny=True).clone(num_classes=NCLS, num_queries=16, dec_layers=1)
    port = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0)
    return jm, port


def _batch(seed=0):
    """A loader-format AVSS v1s batch: uint8 frames and Maskiges, 12 slots of
    class indices of which three are valid in the first frame, the only one
    annotated and weighted; every frame's audio on."""
    rng = np.random.RandomState(seed)
    valid = np.zeros((B, T, K), bool)
    valid[:, 0, :3] = True
    labels = np.zeros((B, T, K), np.int32)
    labels[:, 0, :3] = [0, 17, 42]
    return {
        "images": rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8),
        "audio_log_mel": rng.randn(B, T, 96, 64).astype(np.float32),
        "pre_masks": rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8),
        "labels": labels,
        "masks": (rng.rand(B, T, K, S, S) > 0.5) & valid[..., None, None],
        "valid": valid,
        "gt_temporal_mask": np.tile(np.array([1.0] + [0.0] * (T - 1), np.float32), (B, 1)),
        "vid_temporal_mask": np.ones((B, T), np.float32),
    }


def _jax_criterion():
    return JaxSetCriterion(num_classes=NCLS, matcher=JaxHungarianMatcher(num_points=MPTS),
                           num_points=NPTS, oversample_ratio=OS, importance_sample_ratio=ISR,
                           cosine_n_frame=5, exact_topk=True)


def _criterion():
    return SetCriterion(num_classes=NCLS, matcher=HungarianMatcher(num_points=MPTS),
                        num_points=NPTS, oversample_ratio=OS, importance_sample_ratio=ISR,
                        cosine_n_frame=5, exact_topk=True)


def _targets(batch, dtype):
    N = B * T
    return {"labels": batch["labels"].reshape(N, K),
            "masks": batch["masks"].reshape(N, K, S, S).astype(dtype),
            "valid": batch["valid"].reshape(N, K)}


def _port_grads(net, jm):
    """The port's parameter gradients in the JAX parameter tree."""
    gsd = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().numpy()
           for n, p in net.named_parameters()}
    gsd.update({n: np.zeros(b.shape) for n, b in net.named_buffers()})
    return convert_combo_checkpoint(gsd, dec_layers=jm.dec_layers,
                                    enc_layers=jm.enc_layers)["params"]


def test_avss_step_matches_jax_fp64():
    """float64 on both sides: the 7 losses of 2 decoder outputs and a cosine
    term within 1e-9, and every gradient leaf within 1e-8 of its norm (the
    S4 test's bounds); the 12-slot matching is JV's on both sides."""
    jm, port = _models()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    batch = _batch()
    wd = build_weight_dict(dec_layers=jm.dec_layers + 1)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), convert_combo_checkpoint(
            sd, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers))
        crit = _jax_criterion()
        inputs = [batch[k].astype(np.float64) for k in ("images", "audio_log_mel", "pre_masks",
                                                         "vid_temporal_mask")]
        targets = jax.tree.map(jnp.asarray, _targets(batch, np.float64))
        fw = jnp.asarray(batch["gt_temporal_mask"].reshape(-1).astype(np.float64))

        def loss_fn(params):
            out = jm.apply({"params": params, "frozen": v64["frozen"]}, *inputs)
            losses = crit(key, out, targets, frame_weight=fw)
            return jax_total_loss(losses, wd), losses

        (jtot, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        draws = jax_draws(key, jm.dec_layers + 1, B * T, K)
        jgrads = jax.tree.map(np.asarray, jgrads)

    net = port.double().eval()
    losses = compute_losses(net, _criterion(), batch, torch.Generator(),
                            draws=[tuple(map(torch.from_numpy, d)) for d in draws])
    tot = total_loss(losses, wd)
    tot.backward()
    assert set(losses) == set(jlosses) and len(losses) == 2 * 3 + 1
    for k, want in jlosses.items():
        got = float(losses[k].detach())
        assert abs(got - float(want)) <= LOSS_RTOL * max(1.0, abs(float(want))), k
    assert abs(float(tot.detach()) - float(jtot)) <= LOSS_RTOL * abs(float(jtot))

    pgrads = _port_grads(net, jm)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    pflat = jax.tree.leaves(pgrads)
    assert jax.tree.structure(jgrads) == jax.tree.structure(pgrads)
    total = np.sqrt(sum(np.sum(np.asarray(g) ** 2) for g in pflat))
    bad = []
    for (path, gj), gp in zip(jflat, pflat):
        name = jax.tree_util.keystr(path)
        gj, gp = np.asarray(gj), np.asarray(gp)
        scale = max(np.linalg.norm(gj), np.linalg.norm(gp))
        if "audio_backbone" in name:
            assert scale == 0.0, name
            continue
        err = np.linalg.norm(gj - gp)
        if err > GRAD_RL2 * scale + GRAD_FLOOR * total:
            bad.append(f"{name}: |diff| {err:.3e}, |g| {scale:.3e}")
    assert not bad, "\n".join(bad)


def _amp_steps():
    """JAX's make_train_step(amp=True) with SGD at rate 1 (so the gradient is
    the weights' change), and the port's AMP and fp32 losses and gradients on
    the same weights, batch and draws (the draws of the key the JAX step
    splits off for its criterion)."""
    jm, port = _models()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = convert_combo_checkpoint(sd, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    batch = _batch(1)
    wd = build_weight_dict(dec_layers=jm.dec_layers + 1)
    opt = optax.sgd(1.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       frozen=variables["frozen"], opt_state=opt.init(variables["params"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["masks"] = jbatch["masks"].astype(jnp.float32)
    key = jax.random.PRNGKey(9)
    step = jax_make_train_step(jm, _jax_criterion(), wd, opt, amp=True, donate=False)
    new_state, metrics = step(state, jbatch, key)
    jgrads = jax.tree.map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
                          state.params, new_state.params)
    _, km = jax.random.split(jax.random.fold_in(key, 0))
    draws = jax_draws(km, jm.dec_layers + 1, B * T, K)

    out = dict(jlosses={k: float(v) for k, v in metrics.items()}, jgrads=jgrads)
    for name, on in (("amp", True), ("fp32", False)):
        net = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0).eval()
        losses = compute_losses(net, _criterion(), batch, torch.Generator(),
                                draws=[tuple(map(torch.from_numpy, d)) for d in draws], amp=on)
        tot = total_loss(losses, wd)
        tot.backward()
        out[name] = ({"total_loss": float(tot.detach()),
                      **{k: float(v.detach()) for k, v in losses.items()}},
                     _port_grads(net, jm))
    return out


def _grad_rl2(got, want):
    """The rel-L2 distance of two gradient trees, the frozen VGGish tower
    left out."""
    diff = norm = 0.0
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)):
        if "audio_backbone" in jax.tree_util.keystr(path):
            continue
        diff += float(np.sum((np.asarray(g, np.float64) - np.asarray(w, np.float64)) ** 2))
        norm += float(np.sum(np.asarray(w, np.float64) ** 2))
    assert norm > 0
    return float(np.sqrt(diff / norm))


def test_amp_step_matches_jax():
    """The AMP step's total and named losses within AMP_LOSS_RTOL of JAX's
    (and of the port's own fp32 ones), and its whole gradient (every leaf
    but the frozen VGGish tower), taken on the float32 weights through the
    bf16 forward, within AMP_GRAD_RL2 rel-L2 of JAX's AMP gradient and of
    the port's fp32 one. One test, so that a distributed run computes the
    JAX step once."""
    amp = _amp_steps()
    want = amp["jlosses"]
    for got in (amp["amp"][0], amp["fp32"][0]):
        assert set(got) == set(want) and len(got) == 2 * 3 + 1 + 1
        errs = {k: abs(got[k] - want[k]) / max(1.0, abs(want[k])) for k in want}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= AMP_LOSS_RTOL, (worst, got[worst], want[worst])
    assert _grad_rl2(amp["amp"][1], amp["jgrads"]) <= AMP_GRAD_RL2
    assert _grad_rl2(amp["amp"][1], amp["fp32"][1]) <= AMP_GRAD_RL2


def test_amp_train_step_keeps_float32_masters():
    """make_train_step(amp=True): finite losses, the float32 weights updated
    (the frozen tower and buffers not), every parameter still float32."""
    jm, port = _models()
    wd = build_weight_dict(dec_layers=jm.dec_layers + 1)
    step = make_train_step(port, _criterion(), wd, Optimizer(port),
                           torch.Generator().manual_seed(0), amp=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    metrics = step(_batch(2))
    assert set(metrics) == {"total_loss", *wd}
    assert all(bool(torch.isfinite(v)) and v.dtype == torch.float32 for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in port.parameters())
    after = port.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    buffers = {n for n, _ in port.named_buffers()}
    assert not changed & buffers and not any(k.startswith("audio_backbone.") for k in changed)
    assert any(k.startswith("sem_seg_head.predictor.") for k in changed)
