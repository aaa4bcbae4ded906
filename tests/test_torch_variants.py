"""The port's model variants against the JAX package on the CPU: the models
without one of COMBO's components and the alternative decoders, each built
by `build_model` from the shipped S4 config with overrides, at tiny widths
(`tiny_resnet`, one encoder and one decoder layer, 8 queries, 1 video x 5
frames x 64^2, K = 3 target slots):

(a) no pre-SAM tower (no SEM) + MHA-S fusion;
(b) MHA-S-Audio fusion + the "dim" query fusion + COSINE_WEIGHT 0 (no
    inter-frame loss; HIDDEN_DIM 160, since the dim fusion takes 128 of it);
(c) MHA-None fusion + the "all" query fusion + ENFORCE_INPUT_PROJ;
(d) early fusion on res2 + a trained VGGish tower + SGD;
(e) the BasePixelDecoder;
(f) the TransformerEncoderPixelDecoder.

For each, in one test (one JAX compile: `test_variant_matches_jax`): the
port's seeded init goes into the JAX model through the inverse of
`state_dict_from_flax`; the forward in float64 (1e-6 relative: both sides
take float32 position-encoding and reference-point constants) and the
port's float32 forward (1e-4); one float64 training step's losses (1e-6
relative) and gradients (each leaf within 1e-5 rel-L2) against
`jax.value_and_grad` of the JAX step's loss on the same draws; and two
updates of SGD and AdamW against the JAX package's optax chain, from the
same weights and gradient (AdamW only where a parameter gets no gradient).
Dropout is off on both sides.

Also the decoder alone with the none / dim / all query fusions,
`FeatureResizer`, `func_attention`, `l1norm` and `l2norm`, an early fusion
that lists one level twice (the JAX module runs it), each variant's
reference checkpoint round trip, `train_net` and `pred` on (a) with SGD,
and the refusals: the 12 `*-SemanticSegmentation.yaml` bases, PRE_NORM
True, two different early-fusion levels."""

import copy
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from combo_avs_tpu import config as jax_config
from combo_avs_tpu.losses.criterion import SetCriterion as JaxSetCriterion
from combo_avs_tpu.losses.criterion import build_weight_dict as jax_build_weight_dict
from combo_avs_tpu.losses.criterion import total_loss as jax_total_loss
from combo_avs_tpu.losses.matcher import HungarianMatcher as JaxHungarianMatcher
from combo_avs_tpu.models import fusion as jax_fusion
from combo_avs_tpu.models.meta_arch import build_model as jax_build_model
from combo_avs_tpu.train.optim import build_optimizer as jax_build_optimizer
from combo_avs_torch import config
from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict, total_loss
from combo_avs_torch.losses.matcher import HungarianMatcher
from combo_avs_torch.models import fusion
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import build_model
from combo_avs_torch.train.checkpoint import (load_reference_checkpoint,
                                              save_reference_checkpoint,
                                              state_dict_from_flax)
from combo_avs_torch.train.optim import build_optimizer
from combo_avs_torch.train.train_step import compute_losses
from tests.test_torch_config import S4, TINY_OPTS
from tests.test_torch_losses import ISR, MPTS, NPTS, OS, jax_draws
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401

B, T, S, K = 1, 5, 64, 3
FWD_RTOL = {"fp64": 1e-6, "fp32": 1e-4}
LOSS_RTOL, GRAD_RL2 = 1e-6, 1e-5
# leaves whose gradient is exactly zero in exact arithmetic (a bias ahead of
# a GroupNorm, the fusion's query bias, ...) carry rounding noise on both
# sides: their error is also allowed 1e-12 of the whole gradient's norm
GRAD_FLOOR = 1e-12
VARIANTS = {
    "a_nosem_mha_s": ["MODEL.PRE_SAM.USE_PRE_SAM", "False", "MODEL.FUSE_CONFIG.TYPE", "MHA-S"],
    "b_s_audio_dim_nocos": ["MODEL.FUSE_CONFIG.TYPE", "MHA-S-Audio",
                            "MODEL.FUSE_CONFIG.QUERIES_FUSE_TYPE", "dim",
                            "MODEL.MASK_FORMER.COSINE_WEIGHT", "0.0",
                            "MODEL.MASK_FORMER.HIDDEN_DIM", "160"],
    "c_none_all_proj": ["MODEL.FUSE_CONFIG.TYPE", "MHA-None",
                        "MODEL.FUSE_CONFIG.QUERIES_FUSE_TYPE", "all",
                        "MODEL.MASK_FORMER.ENFORCE_INPUT_PROJ", "True"],
    "d_early_vggish_sgd": ["MODEL.FUSE_CONFIG.FUSION_STEP", "early",
                           "MODEL.AUDIO.FREEZE_AUDIO_EXTRACTOR", "False",
                           "SOLVER.OPTIMIZER", "SGD"],
    "e_base_fpn": ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME", "BasePixelDecoder"],
    "f_transformer_fpn": ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME",
                          "TransformerEncoderPixelDecoder"],
}
# the variants with parameters the loss does not reach: the vision half of
# the MHA-S-Audio block, the "all" fusion's query_feat
ADAMW_TOO = ("b_s_audio_dim_nocos", "c_none_all_proj")
# the SOLVER the optimizer checks take: a warm schedule, every weight decay
# nonzero, the clip on
SOLVER_OPTS = ["SOLVER.BASE_LR", "0.01", "SOLVER.WEIGHT_DECAY_NORM", "0.01",
               "SOLVER.WEIGHT_DECAY_EMBED", "0.02", "SOLVER.MOMENTUM", "0.8",
               "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5"]


def _configs(name, extra=()):
    opts = TINY_OPTS + ["MODEL.MASK_FORMER.DEC_LAYERS", "2"] + VARIANTS[name] + list(extra) + [
        "MODEL.DEVICE", "cpu"]
    return config.setup_cfg(S4, opts), jax_config.setup_cfg(S4, opts)


def _batch(seed=0):
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
        "masks": rng.rand(B, T, K, S, S) > 0.5,
        "valid": valid,
        "gt_temporal_mask": np.tile(np.array([1.0] + [0.0] * (T - 1), np.float32), (B, 1)),
    }


def _x64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _inputs(jm, batch, dtype):
    pre = batch["pre_masks"].astype(dtype) if jm.use_pre_sam else None
    return batch["images"].astype(dtype), batch["audio_log_mel"].astype(dtype), pre


def flax_from_state_dict(sd, shapes, dec_layers, enc_layers):
    """The inverse of `state_dict_from_flax`: the port's state dict `sd` into
    the JAX variable tree of `shapes` (jax.eval_shape of the JAX init). Each
    JAX element gets its flat index; `state_dict_from_flax` of that index
    tree says where each port element comes from, so scattering the port's
    values there inverts the mapping exactly (transposes and unstacked scans
    included). Every JAX element must be covered once."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    sizes = [int(np.prod(a.shape)) for a in leaves]
    offsets = np.cumsum([0] + sizes)
    ids = jax.tree_util.tree_unflatten(treedef, [
        np.arange(o, o + n, dtype=np.int64).reshape(a.shape)
        for o, n, a in zip(offsets, sizes, leaves)])
    where = state_dict_from_flax(ids, dec_layers=dec_layers, enc_layers=enc_layers)
    assert set(where) == set(sd), sorted(set(where) ^ set(sd))[:8]
    flat = np.full(offsets[-1], np.nan)
    hits = np.zeros(offsets[-1], np.int64)
    for k, idx in where.items():
        flat[np.ravel(idx)] = np.ravel(np.asarray(sd[k], np.float64))
        np.add.at(hits, np.ravel(idx), 1)
    assert (hits == 1).all(), "a JAX variable is not covered exactly once"
    return jax.tree_util.tree_unflatten(treedef, [
        flat[o:o + n].reshape(a.shape) for o, n, a in zip(offsets, sizes, leaves)])


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
                 / max(np.abs(np.asarray(want, np.float64)).max(), 1e-30))


def _jax_step(jm, jcfg, variables, batch, key):
    """JAX, float64: value_and_grad of make_train_step's loss (the model's
    training forward, the criterion on this key, the weighted total) with
    the forward's outputs, and the criterion's draws."""
    N = B * T
    wd = jax_build_weight_dict(jcfg)
    crit = JaxSetCriterion(num_classes=2, matcher=JaxHungarianMatcher(num_points=MPTS),
                           num_points=NPTS, oversample_ratio=OS, importance_sample_ratio=ISR,
                           cosine_n_frame=T, exact_topk=True)
    inputs = _inputs(jm, batch, np.float64)
    targets = {"labels": batch["labels"].reshape(N, K),
               "masks": batch["masks"].reshape(N, K, S, S).astype(np.float64),
               "valid": batch["valid"].reshape(N, K)}
    fw = batch["gt_temporal_mask"].reshape(-1).astype(np.float64)

    def loss_fn(params):
        out = jm.apply({**variables, "params": params}, *inputs)
        losses = crit(key, out, jax.tree.map(jnp.asarray, targets), frame_weight=jnp.asarray(fw))
        return jax_total_loss(losses, wd), (losses, out)

    (tot, (losses, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    # drawn under x64, as the criterion drew them
    draws = jax_draws(key, jm.dec_layers + 1, N, K)
    return (float(tot), {k: float(a) for k, a in losses.items()}, jax.tree.map(np.asarray, out),
            jax.tree.map(np.asarray, grads), draws)


def _outputs_close(got, want, rtol):
    pairs = [(got["pred_logits"], want["pred_logits"]), (got["pred_masks"], want["pred_masks"])]
    pairs += [(g[k], w[k]) for g, w in zip(got["aux_outputs"], want["aux_outputs"])
              for k in ("pred_logits", "pred_masks")]
    pairs += list(zip(got["middles_attn_mask"], want["middles_attn_mask"]))
    assert len(got["aux_outputs"]) == len(want["aux_outputs"])
    assert len(got["middles_attn_mask"]) == len(want["middles_attn_mask"])
    for g, w in pairs:
        assert tuple(g.shape) == w.shape
        assert _rel(g.detach().numpy(), w) <= rtol, _rel(g.detach().numpy(), w)


def _two_updates(tx, grads, params):
    state = tx.init(params)
    for _ in range(2):
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
    return params


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(name):
    """One variant, one JAX compile: the port's seeded init carried into the
    JAX model through the inverse of `state_dict_from_flax`; then

    * the forward (the training forward is the eval one: dropout is off) in
      float64 within 1e-6 relative of JAX's, and the port's float32 forward
      within 1e-4 of it;
    * the float64 step's losses (1e-6 relative) and each parameter's
      gradient (1e-5 rel-L2) against JAX's, on the criterion's draws; a
      frozen VGGish tower has no gradient, the trained one of (d) has one;
    * two updates of SGD (and of AdamW for ADAMW_TOO; SOLVER_OPTS) by the
      port's `Optimizer` against the JAX package's optax chain, from the
      same weights and JAX's gradient, every parameter to 1e-9 relative."""
    cfg, jcfg = _configs(name)
    jm = jax_build_model(jcfg)
    port = init_weights(build_model(cfg), seed=0)
    sd = {k: v.double().numpy() for k, v in port.state_dict().items()}
    batch, key = _batch(), jax.random.PRNGKey(3)
    assert jax_build_weight_dict(jcfg) == build_weight_dict(cfg)
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                *_inputs(jm, batch, np.float64)))
        variables = flax_from_state_dict(sd, shapes, jm.dec_layers, jm.enc_layers)
        jtot, jlosses, jout, jgrads, draws = _jax_step(jm, jcfg, variables, batch, key)

    # the forward
    net = port.double().eval()
    out = net(*(None if a is None else torch.from_numpy(a)
                for a in _inputs(jm, batch, np.float64)))
    _outputs_close(out, jout, FWD_RTOL["fp64"])
    assert len(out["middles_attn_mask"]) == (0 if "nocos" in name else jm.dec_layers)
    with torch.no_grad():
        out32 = copy.deepcopy(net).float()(*(None if a is None else torch.from_numpy(a)
                                             for a in _inputs(jm, batch, np.float32)))
    _outputs_close(out32, jout, FWD_RTOL["fp32"])

    # the step
    crit = SetCriterion(matcher=HungarianMatcher(num_points=MPTS), num_points=NPTS,
                        oversample_ratio=OS, importance_sample_ratio=ISR)
    losses = compute_losses(net, crit, batch, torch.Generator(),
                            draws=[tuple(map(torch.from_numpy, d)) for d in draws])
    tot = total_loss(losses, build_weight_dict(cfg))
    tot.backward()
    n_cos = 0 if "nocos" in name else jm.dec_layers
    assert set(losses) == set(jlosses) and len(losses) == 3 * (jm.dec_layers + 1) + n_cos
    for k, want in jlosses.items():
        assert abs(float(losses[k].detach()) - want) <= LOSS_RTOL * max(1.0, abs(want)), k
    assert abs(float(tot.detach()) - jtot) <= LOSS_RTOL * abs(jtot)
    zero = {k: jax.tree.map(np.zeros_like, a) for k, a in variables.items() if k != "params"}
    jsd = state_dict_from_flax({"params": jgrads, **zero}, dec_layers=jm.dec_layers,
                               enc_layers=jm.enc_layers)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in net.named_parameters()}
    total = np.sqrt(sum(np.sum(g ** 2) for g in grads.values()))
    audio = sum(np.abs(g).sum() for k, g in grads.items() if k.startswith("audio_backbone."))
    assert (audio > 0) == ("vggish" in name)
    bad = []
    for k, g in grads.items():
        w = np.asarray(jsd[k])
        scale = max(np.linalg.norm(g), np.linalg.norm(w))
        err = np.linalg.norm(g - w)
        if err > GRAD_RL2 * scale + GRAD_FLOOR * total:
            bad.append(f"{k}: |diff| {err:.3e}, |g| {scale:.3e}")
    assert not bad, "\n".join(bad)

    # the updates, from JAX's gradient: SGD on every variant, AdamW where a
    # parameter gets no gradient (it still decays, and its moments decay)
    for opt_name in ("SGD", "ADAMW") if name in ADAMW_TOO else ("SGD",):
        ocfg, ojcfg = _configs(name, SOLVER_OPTS + ["SOLVER.OPTIMIZER", opt_name])
        with jax.enable_x64(True):
            tx, _ = jax_build_optimizer(ojcfg, variables["params"])
            params = jax.jit(functools.partial(_two_updates, tx))(jgrads, variables["params"])
            want = state_dict_from_flax(_x64({**variables, "params": params}),
                                        dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
        moved = copy.deepcopy(net)
        opt = build_optimizer(ocfg, moved)
        assert type(opt.inner).__name__ == ("TraceSGD" if opt_name == "SGD" else "AdamW")
        for _ in range(2):
            for n, p in moved.named_parameters():
                p.grad = torch.from_numpy(np.array(jsd[n]))
            opt.step()
        for n, p in moved.named_parameters():
            got, w = p.detach().numpy(), np.asarray(want[n])
            assert np.abs(got - w).max() <= 1e-9 * max(1.0, np.abs(w).max()), (opt_name, n)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_reference_checkpoint_round_trip(name, tmp_path):
    """A variant's `model_best.pth` (reference key names) loads back into
    the variant's model exactly; into the flagship it raises, naming the
    keys that differ (the pre-SAM tower of a model without one is filled
    from the visual tower, as for a reference file, but its SE gates are
    not)."""
    cfg, _ = _configs(name)
    model = init_weights(build_model(cfg), seed=1)
    path = str(tmp_path / "model_best.pth")
    save_reference_checkpoint(model, path)
    fresh = build_model(cfg)
    load_reference_checkpoint(fresh, path)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    flagship = build_model(config.setup_cfg(S4, TINY_OPTS + ["MODEL.DEVICE", "cpu"]))
    with pytest.raises(ValueError, match="missing keys|unexpected keys"):
        load_reference_checkpoint(flagship, path)


def test_train_net_and_pred_on_a_variant_with_sgd(tmp_path):
    """`train_net` on a variant as a user runs it, with trailing overrides:
    the model without the SEM tower, MHA-S and SGD, 2 iterations with an
    evaluation and a checkpoint at 2 over a synthetic S4 tree (its batches
    carry no Maskiges); `pred` on its model_best.pth with the same
    overrides scores what the run's evaluation scored; `--resume` restores
    the SGD momentum buffers."""
    from combo_avs_torch import pred, train_net
    from combo_avs_torch.data.catalogs import DatasetCatalog, register_all
    from combo_avs_torch.data.synth import make_s4
    from combo_avs_torch.train.trainer import Trainer, build_mapper
    from tests.test_torch_trainer import TINY_RUN

    root, out = str(tmp_path / "s4"), str(tmp_path / "out")
    make_s4(root, n_train=2, n_val=1, size=64)
    register_all(root)
    variant = VARIANTS["a_nosem_mha_s"] + ["SOLVER.OPTIMIZER", "SGD"]
    opts = TINY_RUN + ["SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
                       "TEST.EVAL_PERIOD", "2", "OUTPUT_DIR", out] + variant
    cfg = config.setup_cfg(S4, opts)
    sample = build_mapper(cfg, is_train=True)(DatasetCatalog["avss4_sem_seg_train"]()[0], 0)
    assert "pre_masks" not in sample
    argv = ["--config-file", S4, "--datasets-root", root, "--log-every", "1"]
    trainer = train_net.main(argv + opts)
    assert type(trainer.optimizer.inner).__name__ == "TraceSGD"
    assert not trainer.model.use_pre_sam
    best = trainer.best_ckpt.best
    res = pred.main(["--datasets-root", root, "--checkpoint", os.path.join(out, "model_best.pth"),
                     "--config-file", S4, "--dataset", "avss4_sem_seg_val", "--batch-size",
                     "1", "--device", "cpu", *TINY_RUN, *variant])
    assert res["sem_seg"]["mIoU"] == best
    resumed = Trainer(cfg)
    resumed.resume_or_load(resume=True)
    assert resumed.start_iter == 2
    for p, q in zip(trainer.optimizer.params, resumed.optimizer.params):
        want = trainer.optimizer.inner.state[p]["momentum_buffer"]
        torch.testing.assert_close(resumed.optimizer.inner.state[q]["momentum_buffer"], want,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("fuse", ["none", "dim", "all"])
def test_decoder_query_fusion_matches_jax(fuse):
    """The masked decoder alone with each query fusion but "add" (which the
    other tests take), its weights from the JAX module's init through
    `state_dict_from_flax`'s predictor mapping: the float64 outputs agree."""
    from combo_avs_tpu.models import transformer_decoder as jtd
    from combo_avs_torch.models import transformer_decoder
    from combo_avs_torch.train.checkpoint import _predictor

    C, A, Q, dec = 32, 8 if fuse == "dim" else 32, 5, 2
    rng = np.random.RandomState(7)
    xs = [rng.randn(2, s, s, 16) for s in (2, 4, 8)]
    audio = rng.randn(2, 1, A)
    mask_features = rng.randn(2, 16, 16, C)
    jmod = jtd.MultiScaleMaskedTransformerDecoder(
        num_classes=2, hidden_dim=C, num_queries=Q, nheads=2, dim_feedforward=64,
        dec_layers=dec, mask_dim=C, queries_fuse_type=fuse, audio_out_dim=A)
    v, want = _jax_apply(jmod, xs, audio, mask_features)
    sd = {}
    _predictor(sd, "", v["params"], dec)
    port = transformer_decoder.MultiScaleMaskedTransformerDecoder(
        2, hidden_dim=C, num_queries=Q, nheads=2, dim_feedforward=64, dec_layers=dec,
        mask_dim=C, in_channels=16, queries_fuse_type=fuse, audio_out_dim=A).double().eval()
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()}, strict=True)
    assert port.query_feat.weight.shape == (Q, C - A if fuse == "dim" else C)
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        got = port([nchw(x) for x in xs], torch.from_numpy(audio), nchw(mask_features))
    for k in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------- helpers


def _jax_apply(module, *args, seed=0):
    """float64 variables of a JAX module's init and its output on them (the
    variables as JAX arrays: a numpy table would refuse an index that a JAX
    array clamps)."""
    with jax.enable_x64(True):
        v = _x64(module.init(jax.random.PRNGKey(seed), *args))
        return v, jax.tree.map(np.asarray, module.apply(jax.tree.map(jnp.asarray, v), *args))


def test_feature_resizer_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 12)
    (v, want) = _jax_apply(jax_fusion.FeatureResizer(output_dim=7), x)
    port = fusion.FeatureResizer(12, 7).double().eval()
    p = v["params"]
    with torch.no_grad():
        port.fc.weight.copy_(torch.from_numpy(p["fc"]["kernel"].T))
        port.fc.bias.copy_(torch.from_numpy(p["fc"]["bias"]))
        port.layer_norm.weight.copy_(torch.from_numpy(p["layer_norm"]["scale"]))
        port.layer_norm.bias.copy_(torch.from_numpy(p["layer_norm"]["bias"]))
        got = port(torch.from_numpy(x)).numpy()
    assert port.layer_norm.eps == 1e-12
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    train = fusion.FeatureResizer(12, 7).double().train()
    out = train(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert ((out == 0).double().mean() > 0) and torch.isfinite(out).all()


@pytest.mark.parametrize("norm", ["softmax", "l2norm", "clipped_l2norm"])
def test_func_attention_matches_jax(norm):
    rng = np.random.RandomState(1)
    q, c = rng.randn(2, 3, 8), rng.randn(2, 5, 8)
    with jax.enable_x64(True):
        wj, aj = jax_fusion.func_attention(q, c, smooth=4.0, raw_feature_norm=norm)
    wp, ap = fusion.func_attention(torch.from_numpy(q), torch.from_numpy(c), smooth=4.0,
                                   raw_feature_norm=norm)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-12, atol=1e-12)


def test_l1norm_l2norm_match_jax():
    x = np.random.RandomState(2).randn(3, 4, 5)
    with jax.enable_x64(True):
        for axis in (0, 1, 2):
            np.testing.assert_allclose(fusion.l1norm(torch.from_numpy(x), axis).numpy(),
                                       np.asarray(jax_fusion.l1norm(x, axis)), rtol=1e-14)
            np.testing.assert_allclose(fusion.l2norm(torch.from_numpy(x), axis).numpy(),
                                       np.asarray(jax_fusion.l2norm(x, axis)), rtol=1e-14)
    with pytest.raises(ValueError, match="unknown norm"):
        fusion.func_attention(torch.zeros(1, 1, 2), torch.zeros(1, 1, 2), raw_feature_norm="x")


@pytest.mark.parametrize("fused_type", ["MHA-B", "MHA-S", "MHA-S-Audio", "MHA-None"])
def test_fusion_with_a_repeated_level_matches_jax(fused_type):
    """AVFuse with one level listed twice runs in JAX (its one-row level
    embedding read at index 1 gives row 0, the embedding is added twice and
    the second pass's output wins): the port computes the same."""
    rng = np.random.RandomState(3)
    feat, audio = rng.randn(2, 4, 4, 16), rng.randn(2, 1, 128)
    jmod = jax_fusion.AVFuse(fused_type=fused_type, audio_dim=128, fused_backbone=("res2", "res2"),
                             fused_backbone_dim=(16, 16))
    v, want = _jax_apply(jmod, {"res2": feat}, audio)
    port = fusion.AVFuse(128, ("res2", "res2"), (16, 16), fused_type).double().eval()
    sd = {}
    from combo_avs_torch.train.checkpoint import _fusion
    _fusion(sd, "", v["params"])
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()}, strict=True)
    with torch.no_grad():
        vis, aud = port({"res2": torch.from_numpy(feat).permute(0, 3, 1, 2)},
                        torch.from_numpy(audio))
    np.testing.assert_allclose(vis["res2"].permute(0, 2, 3, 1).numpy(), want["visual"]["res2"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(aud.numpy(), want["audio"], rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------- refusals

BASES = sorted(glob.glob(os.path.join(os.path.dirname(S4), "..", "*",
                                      "*-SemanticSegmentation.yaml")))


@pytest.mark.parametrize("path", BASES, ids=os.path.basename)
def test_semantic_segmentation_bases_raise_naming_the_key(path):
    """The 12 bases set early fusion with no fused level: the JAX forward
    fails on max() of an empty list; the port's build_model names the key."""
    assert len(BASES) == 12
    cfg = config.setup_cfg(path)
    fuse = cfg.MODEL.FUSE_CONFIG
    assert fuse.FUSION_STEP == "early" and not fuse.FUSED_BACKBONE_DIM
    with pytest.raises(ValueError, match="MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM"):
        build_model(cfg, device="meta")


@pytest.mark.parametrize("opts, key", [
    (["MODEL.MASK_FORMER.PRE_NORM", "True"], "MODEL.MASK_FORMER.PRE_NORM"),
    (["MODEL.FUSE_CONFIG.FUSION_STEP", "early", "MODEL.FUSE_CONFIG.FUSED_BACKBONE",
      "['res2', 'res3']", "MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM", "[32, 64]"],
     "MODEL.FUSE_CONFIG.FUSED_BACKBONE"),
    (["MODEL.FUSE_CONFIG.FUSION_STEP", "early", "MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM", "[64]"],
     "MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM"),
    (["MODEL.FUSE_CONFIG.AUDIO_DIM", "1024"], "MODEL.FUSE_CONFIG.AUDIO_DIM"),
], ids=["pre_norm", "two_early_levels", "early_width", "audio_dim"])
def test_settings_the_jax_forward_fails_on_raise(opts, key):
    cfg = config.setup_cfg(S4, TINY_OPTS + opts)
    with pytest.raises(ValueError, match=key):
        build_model(cfg, device="meta")


def test_two_early_levels_fail_in_jax_too():
    """The JAX forward raises on two different early-fusion levels (the
    level embedding has the first level's width), which is why the port
    refuses them."""
    jcfg = jax_config.setup_cfg(S4, TINY_OPTS + [
        "MODEL.FUSE_CONFIG.FUSION_STEP", "early", "MODEL.FUSE_CONFIG.FUSED_BACKBONE",
        "['res2', 'res3']", "MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM", "[32, 64]"])
    jm = jax_build_model(jcfg)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *_inputs(jm, _batch(), np.float32)))
