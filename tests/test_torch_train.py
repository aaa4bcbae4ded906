"""The PyTorch port's S4 training slice against the JAX package on the CPU:
the training forward, criterion and weighted total loss, and their gradient
with respect to every parameter, on the tiny flagship
(`_flagship_model(tiny=True)`: 1 video x 5 frames x 64^2, K = 3 target
slots, S4 frame weights). Also the port's train step, its dropout, the eval
step's per-call mode switch, and the default device.

Weights come from the port's seeded init and go through
`convert_combo_checkpoint` into the JAX model; gradients take the same road
(port `p.grad` -> converter -> the JAX parameter tree), as
tests/test_grad_oracle.py does. The JAX criterion's random draws are
recovered from its key and injected into the port's. Dropout is off on both
sides (the JAX model is built deterministic, the port runs in eval mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from combo_avs_tpu.losses.criterion import SetCriterion as JaxSetCriterion
from combo_avs_tpu.losses.criterion import total_loss as jax_total_loss
from combo_avs_tpu.losses.matcher import HungarianMatcher as JaxHungarianMatcher
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict, total_loss
from combo_avs_torch.losses.matcher import HungarianMatcher
from combo_avs_torch.models import meta_arch
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.train.optim import Optimizer
from combo_avs_torch.train.train_step import compute_losses, make_eval_step, make_train_step
from tests.test_torch_losses import ISR, MPTS, NPTS, OS, jax_draws
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)

B, T, S, K = 1, 5, 64, 3
# float64 on both sides, the same function: the losses agree to rounding, and
# each gradient leaf to 1e-8 of its norm. A few leaves have an exactly zero
# gradient (a bias followed by a GroupNorm, which subtracts it again; the
# fusion's query bias, which moves every logit of a softmax alike), so both
# sides return rounding noise there: the error is also allowed 1e-12 of the
# whole gradient's norm.
LOSS_RTOL, GRAD_RL2, GRAD_FLOOR = 1e-9, 1e-8, 1e-12


def _fields():
    jm = graft._flagship_model(tiny=True)
    return jm, _port_kwargs(jm)


def _batch(seed=0, masks_dtype=np.float64):
    """A loader-format S4 batch: uint8 frames and Maskiges, K = 3 slots of
    which the first two are valid, the first frame of the video weighted."""
    rng = np.random.RandomState(seed)
    valid = np.zeros((B, T, K), bool)
    valid[..., :2] = True
    return {
        "images": rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8),
        "audio_log_mel": rng.randn(B, T, 96, 64).astype(np.float32),
        "pre_masks": rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8),
        "labels": rng.randint(0, 2, (B, T, K)).astype(np.int32),
        "masks": (rng.rand(B, T, K, S, S) > 0.5).astype(masks_dtype),
        "valid": valid,
        "gt_temporal_mask": np.tile(np.array([1.0] + [0.0] * (T - 1), np.float32), (B, 1)),
    }


def _criterion():
    return SetCriterion(matcher=HungarianMatcher(num_points=MPTS), num_points=NPTS,
                        oversample_ratio=OS, importance_sample_ratio=ISR)


@pytest.fixture(scope="module")
def oracle():
    """JAX: total loss, named losses and gradients of the tiny flagship's
    training loss (the composition of train_step.py's loss_fn) in float64,
    and the draws its criterion made. Port: the same, from the same weights."""
    jm, fields = _fields()
    port = init_weights(MaskFormer(**fields, device="cpu"), seed=0)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    kw = dict(dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    batch = _batch()
    wd = build_weight_dict(dec_layers=jm.dec_layers + 1)
    key = jax.random.PRNGKey(3)
    N = B * T
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           convert_combo_checkpoint(sd, **kw))
        crit = JaxSetCriterion(num_classes=2, matcher=JaxHungarianMatcher(num_points=MPTS),
                               num_points=NPTS, oversample_ratio=OS, importance_sample_ratio=ISR,
                               cosine_n_frame=T, exact_topk=True)
        inputs = [batch[k].astype(np.float64) for k in ("images", "audio_log_mel", "pre_masks")]
        targets = {"labels": batch["labels"].reshape(N, K),
                   "masks": batch["masks"].reshape(N, K, S, S),
                   "valid": batch["valid"].reshape(N, K)}
        fw = batch["gt_temporal_mask"].reshape(-1).astype(np.float64)

        def loss_fn(params):
            out = jm.apply({"params": params, "frozen": v64["frozen"]}, *inputs)
            losses = crit(key, out, jax.tree.map(jnp.asarray, targets),
                          frame_weight=jnp.asarray(fw))
            return jax_total_loss(losses, wd), losses

        (jtot, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        jlosses = {k: float(v) for k, v in jlosses.items()}
        draws = jax_draws(key, jm.dec_layers + 1, N, K)
        jgrads = jax.tree.map(np.asarray, jgrads)

    net = port.double().eval()
    losses = compute_losses(net, _criterion(), batch, torch.Generator(),
                            draws=[tuple(map(torch.from_numpy, d)) for d in draws])
    tot = total_loss(losses, wd)
    tot.backward()
    gsd = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in net.named_parameters()}
    gsd.update({n: np.zeros(b.shape) for n, b in net.named_buffers()})
    pgrads = convert_combo_checkpoint(gsd, **kw)["params"]
    return dict(jtot=float(jtot), jlosses=jlosses, jgrads=jgrads, tot=float(tot.detach()),
                losses={k: float(v) for k, v in losses.items()}, grads=pgrads)


def test_slice_losses_match_jax_fp64(oracle):
    assert set(oracle["losses"]) == set(oracle["jlosses"])
    # 3 decoder outputs (ce, mask, dice each) and 2 cosine terms
    assert len(oracle["losses"]) == 11
    for k, want in oracle["jlosses"].items():
        got = oracle["losses"][k]
        assert abs(got - want) <= LOSS_RTOL * max(1.0, abs(want)), (k, got, want)
    assert abs(oracle["tot"] - oracle["jtot"]) <= LOSS_RTOL * abs(oracle["jtot"])


def test_slice_gradients_match_jax_fp64(oracle):
    """Per-leaf rel-L2 of the port's gradient (through the converter) against
    jax.value_and_grad of the same loss. The frozen VGGish tower has no
    gradient on either side (the port runs it under no_grad, JAX under
    stop_gradient)."""
    jflat = jax.tree_util.tree_flatten_with_path(oracle["jgrads"])[0]
    pflat = jax.tree.leaves(oracle["grads"])
    assert jax.tree.structure(oracle["jgrads"]) == jax.tree.structure(oracle["grads"])
    total = np.sqrt(sum(np.sum(np.asarray(g) ** 2) for g in pflat))
    bad, compared = [], 0
    for (path, gj), gp in zip(jflat, pflat):
        name = jax.tree_util.keystr(path)
        gj, gp = np.asarray(gj), np.asarray(gp)
        scale = max(np.linalg.norm(gj), np.linalg.norm(gp))
        if "audio_backbone" in name:
            assert scale == 0.0, name
            continue
        compared += 1
        err = np.linalg.norm(gj - gp)
        if err > GRAD_RL2 * scale + GRAD_FLOOR * total:
            bad.append(f"{name}: |diff| {err:.3e}, |g| {scale:.3e}, |all| {total:.3e}")
    assert not bad, "\n".join(bad)
    assert compared > 100


def test_train_step_updates_what_it_should():
    """One make_train_step step (fp32, CPU): finite losses under every
    weight-dict name; the frozen VGGish tower and FrozenBN buffers unchanged,
    the decoder changed; the model's mode restored."""
    _, fields = _fields()
    model = init_weights(MaskFormer(**fields, device="cpu"), seed=1).eval()
    wd = build_weight_dict(dec_layers=fields["dec_layers"] + 1)
    step = make_train_step(model, _criterion(), wd, Optimizer(model),
                           torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = step(_batch(1, masks_dtype=bool))
    assert set(metrics) == {"total_loss", *wd}
    assert all(bool(torch.isfinite(v)) and v.dim() == 0 for v in metrics.values())
    assert not model.training
    after = model.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert not any(k.startswith("audio_backbone.") for k in changed)
    buffers = {n for n, _ in model.named_buffers()}
    assert not changed & buffers  # FrozenBN statistics and affine, constants
    assert any(k.startswith("sem_seg_head.predictor.") for k in changed)
    assert any(k.startswith("backbone.") for k in changed)
    # amp=True (the AVSS regime) builds a step; tests/test_torch_avss_train.py
    # holds it against the JAX package's
    assert callable(make_train_step(model, _criterion(), wd, Optimizer(model),
                                    torch.Generator(), amp=True))


def test_dropout_is_drawn_from_the_generator():
    """In training mode the fusion's attention dropout changes the outputs,
    and the same generator seed reproduces them; without a generator it
    refuses to draw."""
    _, fields = _fields()
    model = init_weights(MaskFormer(**fields, device="cpu"), seed=2)
    b = _batch(2)
    inputs = [torch.from_numpy(b[k].astype(np.float32))
              for k in ("images", "audio_log_mel", "pre_masks")]
    with torch.no_grad():
        ref = model.eval()(*inputs)["pred_masks"]
        model.train()
        a = model(*inputs, dropout_generator=torch.Generator().manual_seed(5))["pred_masks"]
        a2 = model(*inputs, dropout_generator=torch.Generator().manual_seed(5))["pred_masks"]
        c = model(*inputs, dropout_generator=torch.Generator().manual_seed(6))["pred_masks"]
        with pytest.raises(ValueError, match="Generator"):
            model(*inputs)
    assert torch.equal(a, a2)
    assert not torch.equal(a, ref) and not torch.equal(a, c)


@pytest.mark.parametrize("bf16", [False, True])
def test_eval_step_runs_in_eval_mode_at_each_call(bf16):
    """A step made from a model in eval mode, called after model.train(),
    gives the eval-mode output exactly and leaves the model in train mode."""
    _, fields = _fields()
    model = init_weights(MaskFormer(**fields, device="cpu"), seed=3).eval()
    batch = _batch(3)
    step = make_eval_step(model, (S, S), bf16=bf16)
    want = step(batch)
    model.train()
    got = step(batch)
    assert model.training
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_model_defaults_to_the_card(monkeypatch):
    """MaskFormer(device=None) builds on the current CUDA device; without one
    it refuses rather than fall back to the CPU."""
    assert meta_arch.default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskFormer(backbone_name="tiny_resnet")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert meta_arch.default_device(None) == torch.device("cuda", 0)
