"""The PyTorch port's PVTv2-B5 path against the JAX package on the CPU.

At the B5 widths (64/128/320/512, heads 1/2/5/8, sr 8/4/2/1) and cut
depths, on the same numpy inputs made from a seed, in float64 on both
sides: the modules (`SRAttention` at sr 8 and 1, `ConvMlp`, `PVTBlock`,
`PVTv2`), the full `MaskFormer` through `state_dict_from_flax`, and one
training step (losses and every gradient leaf). At float64 both sides
compute the same function to rounding, so the forward tolerance is 1e-9 of
the output's scale, as the R50 module tests'; the training step's are
tests/test_torch_train.py's (losses 1e-9 relative, gradients 1e-8 of each
leaf's norm). Also the checkpoint round trip, the timm importer and
`load_pretrained`, `DropPath`, the B5 parameter count, the optimizer's
groups against the JAX `classify_param`, and `build_model` of the shipped
PVT configs."""

import gc
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combo_avs_tpu import config as jax_config
from combo_avs_tpu.losses.criterion import SetCriterion as JaxSetCriterion
from combo_avs_tpu.losses.criterion import total_loss as jax_total_loss
from combo_avs_tpu.losses.matcher import HungarianMatcher as JaxHungarianMatcher
from combo_avs_tpu.models import pvtv2 as jpvt
from combo_avs_tpu.models.meta_arch import MaskFormer as JaxMaskFormer
from combo_avs_tpu.models.meta_arch import build_model as jax_build_model
from combo_avs_tpu.train import checkpoint as jckpt
from combo_avs_tpu.train.optim import classify_param
from combo_avs_torch import config
from combo_avs_torch.losses.criterion import build_weight_dict, total_loss
from combo_avs_torch.models import pvtv2
from combo_avs_torch.models.layers import DropPath, init_weights
from combo_avs_torch.models.meta_arch import MaskFormer, build_model
from combo_avs_torch.train import checkpoint
from combo_avs_torch.train.optim import param_groups
from combo_avs_torch.train.train_step import compute_losses
from tests.test_torch_losses import ISR, MPTS, NPTS, OS, jax_draws
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)
from tests.test_torch_train import GRAD_FLOOR, GRAD_RL2, LOSS_RTOL, K, T, _batch, _criterion

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "combo_avs_tpu", "configs")
TOL = 1e-9  # float64 on both sides; relative to max |output|
DEPTHS = (1, 2, 1, 1)  # two blocks in stage 2: the scan axis is unstacked in order
S = 64
# the tiny flagship's head (`__graft_entry__._flagship_model(tiny=True)`) on
# PVTv2 towers at the B5 widths
HEAD = dict(vggish_width=0.125, hidden_dim=32, nheads=2, dim_feedforward=64, mask_dim=32,
            conv_dim=32, audio_out_dim=32, dec_layers=2, enc_layers=1, num_queries=8)
PVT_MODEL = dict(backbone_name="build_pvtv2_b5_backbone", pre_sam_dim=(64, 128, 320, 512),
                 pvt_depths=DEPTHS, **HEAD)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _jax_apply(module, variables, *args):
    with jax.enable_x64(True):
        return jax.tree.map(np.asarray, jax.jit(module.apply)(variables, *args))


def _seeded_pvt(seed=0):
    """The port's PVTv2 at DEPTHS in float64: seeded init plus seeded noise
    on every tensor (no weight a trivial 0 or 1), and its JAX params through
    the JAX package's `convert_pvt`."""
    port = init_weights(pvtv2.PVTv2(depths=DEPTHS), seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for t in port.state_dict().values():
            t.add_(torch.from_numpy(0.05 * rng.randn(*t.shape)))
    port = port.double().eval()
    params = jckpt.convert_pvt({k: v.numpy() for k, v in port.state_dict().items()})
    return port, params


@pytest.fixture(scope="module")
def pvt():
    return _seeded_pvt()


def _first(tree):
    """Block 0 of a scan-stacked JAX stage."""
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


@pytest.mark.parametrize("stage", [1, 4], ids=["sr8", "sr1"])
def test_sr_attention_matches_jax(pvt, stage):
    port, params = pvt
    dim, heads, sr, H = (64, 1, 8, 16) if stage == 1 else (512, 8, 1, 4)
    W = H
    x = np.random.RandomState(stage).randn(2, H * W, dim)
    jm = jpvt.SRAttention(dim, heads, sr, spatial=(H, W))
    want = _jax_apply(jm, {"params": _first(params[f"block{stage}"])["attn"]}, x)
    with torch.no_grad():
        got = getattr(port, f"block{stage}")[0].attn(torch.from_numpy(x), H, W)
    _close(got.numpy(), want)


def test_conv_mlp_matches_jax(pvt):
    port, params = pvt
    H = W = S // 8
    x = np.random.RandomState(5).randn(2, H * W, 128)
    jm = jpvt.ConvMlp(128, 512, (H, W))
    want = _jax_apply(jm, {"params": _first(params["block2"])["mlp"]}, x)
    with torch.no_grad():
        got = port.block2[0].mlp(torch.from_numpy(x), H, W)
    _close(got.numpy(), want)


def test_pvt_block_matches_jax(pvt):
    port, params = pvt
    H = W = S // 16
    x = np.random.RandomState(6).randn(2, H * W, 320)
    jm = jpvt.PVTBlock(320, 5, 2, 4, (H, W))
    want, _ = _jax_apply(jm, {"params": _first(params["block3"])}, x, np.float64(0.05))
    with torch.no_grad():
        got = port.block3[0](torch.from_numpy(x), H, W)
    _close(got.numpy(), want)


def test_pvtv2_matches_jax(pvt):
    port, params = pvt
    x = np.random.RandomState(7).randn(2, S, S, 3)
    jm = jpvt.PVTv2(depths=DEPTHS)
    with jax.enable_x64(True):
        init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    assert jax.tree.structure(init) == jax.tree.structure({"params": params})
    want = _jax_apply(jm, {"params": params}, x)
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert list(got) == ["res2", "res3", "res4", "res5"]
    for k, w in want.items():
        _close(got[k].numpy(), w.transpose(0, 3, 1, 2))


def _inputs(seed=0, t=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (1, t, S, S, 3)).astype(np.float64),
            rng.randn(1, t, 96, 64), rng.randint(0, 256, (1, t, S, S, 3)).astype(np.float64))


@pytest.fixture(scope="module")
def seeded_model():
    """The port's PVT MaskFormer from its seeded init, its state dict, and
    the JAX variables `convert_combo_checkpoint(backbone="pvt")` makes of it
    ({"params"} only: a PVT model has no frozen collection)."""
    port = init_weights(MaskFormer(**PVT_MODEL, device="cpu"), seed=2)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = jckpt.convert_combo_checkpoint(sd, backbone="pvt", dec_layers=HEAD["dec_layers"],
                                               enc_layers=HEAD["enc_layers"])
    return port, sd, variables


def test_maskformer_through_state_dict_from_flax_matches_jax(seeded_model):
    """The JAX PVT MaskFormer's variables in float64 through
    `state_dict_from_flax` into a fresh port model: the forwards agree to TOL."""
    _, _, variables = seeded_model
    assert set(variables) == {"params"}
    jm = JaxMaskFormer(**PVT_MODEL)
    images, mel, pre = _inputs()
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    want = _jax_apply(jm, v64, images, mel, pre)
    sd = checkpoint.state_dict_from_flax(v64, dec_layers=HEAD["dec_layers"],
                                         enc_layers=HEAD["enc_layers"])
    port = MaskFormer(**PVT_MODEL, device="cpu").double().eval()
    assert set(sd) == set(port.state_dict())
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (images, mel, pre)))
    for k in ("pred_logits", "pred_masks"):
        _close(got[k].numpy(), want[k])


def test_state_dict_round_trip_through_jax_converter(seeded_model, tmp_path):
    """The port's state dict -> `convert_combo_checkpoint(backbone="pvt")` has
    the JAX init's tree, and `state_dict_from_flax` of it gives back the same
    arrays; a reference file of it loads (`load_reference_checkpoint`), and
    one holding only the visual tower fills both."""
    port, sd, variables = seeded_model
    kw = dict(dec_layers=HEAD["dec_layers"], enc_layers=HEAD["enc_layers"])
    images, mel, pre = _inputs(t=1)
    jm = JaxMaskFormer(**PVT_MODEL)
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), images.astype(np.float32),
                                          mel.astype(np.float32), pre.astype(np.float32)))
    assert jax.tree.structure(init) == jax.tree.structure(variables)
    for a, v in zip(jax.tree.leaves(init), jax.tree.leaves(variables)):
        assert a.shape == np.shape(v)
    back = checkpoint.state_dict_from_flax(variables, **kw)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    path = str(tmp_path / "model_best.pth")
    checkpoint.save_reference_checkpoint(port, path)
    fresh = MaskFormer(**PVT_MODEL, device="cpu")
    checkpoint.load_reference_checkpoint(fresh, path)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    visual = str(tmp_path / "visual.pth")
    torch.save({"model": {k: v for k, v in port.state_dict().items()
                          if not k.startswith("pre_sam_backbone.")}}, visual)
    checkpoint.load_reference_checkpoint(fresh, visual)
    for k, v in fresh.state_dict().items():
        src = k.replace("pre_sam_backbone.", "backbone.", 1)
        assert torch.equal(v, port.state_dict()[src]), k


def test_convert_pvt_and_load_pretrained(tmp_path, caplog):
    """A synthetic timm-named PVTv2 pickle with a classifier `head.*` and
    metadata, as `d2_pvt_v2_b5.pkl` is laid out: `convert_pvt` keeps the
    tower keys, the JAX `convert_pvt` reads the same tower from the file,
    and `load_pretrained` fills both towers with it; a named file that is
    missing leaves the towers as they were."""
    src, _ = _seeded_pvt(seed=3)
    tower = {k: v.float().numpy() for k, v in src.state_dict().items()}
    extra = {"head.weight": np.ones((1000, 512), np.float32),
             "head.bias": np.zeros(1000, np.float32)}
    path = str(tmp_path / "d2_pvt_v2_b5.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": {**tower, **extra}, "__author__": "test"}, f)
    raw = checkpoint.load_reference_file(path)
    got = checkpoint.convert_pvt(raw)
    assert set(got) == set(tower)
    want = jckpt.convert_pvt(raw)
    mine = jckpt.convert_pvt(got)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(mine)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))

    model = init_weights(MaskFormer(**PVT_MODEL, device="cpu"), seed=4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    checkpoint.load_pretrained(model, path)
    sd = model.state_dict()
    for tower_name in ("backbone", "pre_sam_backbone"):
        for k, v in tower.items():
            np.testing.assert_array_equal(sd[f"{tower_name}.{k}"].numpy(), v)
    rest = [k for k in sd if not k.startswith(("backbone.", "pre_sam_backbone."))]
    assert rest and all(torch.equal(sd[k], before[k]) for k in rest)

    fresh = init_weights(MaskFormer(**PVT_MODEL, device="cpu"), seed=4)
    with caplog.at_level(logging.INFO, logger="COMBO"):
        checkpoint.load_pretrained(fresh, str(tmp_path / "missing.pkl"))
    assert "not found" in caplog.text
    assert all(torch.equal(v, before[k]) for k, v in fresh.state_dict().items())
    with pytest.raises(ValueError, match="missing keys"):
        cut = str(tmp_path / "cut.pkl")
        with open(cut, "wb") as f:
            pickle.dump({k: v for k, v in tower.items() if not k.startswith("block4.")}, f)
        checkpoint.load_pretrained(fresh, cut)


def test_drop_path_draws_from_the_generator():
    """Eval mode and rate 0 are the identity; in training mode whole samples
    are zeroed or scaled by 1 / (1 - rate), the same generator seed repeats
    the draw and another seed changes it, and no generator raises. Through
    PVTv2, training-mode outputs follow the generator the same way."""
    dp = DropPath()
    x = torch.randn(64, 5, 7, generator=torch.Generator().manual_seed(0)) + 3.0
    assert dp.eval()(x, 0.5, None) is x
    dp.train()
    assert dp(x, 0.0, None) is x
    a = dp(x, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(a, dp(x, 0.25, torch.Generator().manual_seed(1)))
    assert not torch.equal(a, dp(x, 0.25, torch.Generator().manual_seed(2)))
    kept = (a != 0).flatten(1).all(1)
    assert torch.equal(kept, (a != 0).flatten(1).any(1))  # a sample is kept or dropped whole
    assert 0 < int(kept.sum()) < 64
    torch.testing.assert_close(a[kept], x[kept] / 0.75, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        dp(x, 0.25, None)

    net = init_weights(pvtv2.PVTv2(depths=DEPTHS), seed=0)
    rates = [b.drop_path_rate for i in range(1, 5) for b in getattr(net, f"block{i}")]
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, sum(DEPTHS)), rtol=0, atol=0)
    img = torch.randn(8, 3, S, S, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = net.eval()(img)["res5"]
        net.train()
        t1 = net(img, torch.Generator().manual_seed(3))["res5"]
        t2 = net(img, torch.Generator().manual_seed(3))["res5"]
        t3 = net(img, torch.Generator().manual_seed(4))["res5"]
        with pytest.raises(ValueError, match="Generator"):
            net(img)
    assert torch.equal(t1, t2) and not torch.equal(t1, t3) and not torch.equal(t1, ref)


def test_b5_parameter_count_matches_jax():
    """The B5 tower, built on the meta device (no weights allocated), has the
    JAX `pvtv2_b5()`'s parameter count (tests/test_backbones.py::
    test_pvtv2_b5_shapes_and_param_count: about 81.4 M) and its stage-4
    output shape."""
    model = jpvt.pvtv2_b5()
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(variables["params"]))
    with torch.device("meta"):
        port = pvtv2.PVTv2().eval()
        out = port(torch.zeros(1, 3, 32, 32))
    assert [len(getattr(port, f"block{i}")) for i in range(1, 5)] == [3, 6, 40, 3]
    assert sum(p.numel() for p in port.parameters()) == want and 78e6 < want < 85e6
    assert tuple(out["res2"].shape) == (1, 64, 8, 8) and tuple(out["res5"].shape) == (1, 512, 1, 1)


def test_param_groups_match_jax_classify_param():
    """Every trainable parameter of the PVT model gets the (lr multiplier,
    weight decay) that the JAX `classify_param` gives the leaf it converts
    to: the backbone multiplier on both towers, the norm decay on every
    LayerNorm (`patch_embed.norm`, `attn.norm`, `norm1`, ...), the default
    decay elsewhere."""
    wd, wd_norm, wd_embed, mult = 2.0, 5.0, 9.0, 0.1
    port = MaskFormer(**PVT_MODEL, device="cpu")
    sd = port.state_dict()
    names = list(sd)
    markers = jckpt.convert_combo_checkpoint(
        {k: np.full(v.shape, i + 1, np.float64) for i, (k, v) in enumerate(sd.items())},
        backbone="pvt", dec_layers=HEAD["dec_layers"], enc_layers=HEAD["enc_layers"])
    groups = {n: (g["lr_multiplier"], g["weight_decay"])
              for g in param_groups(port, wd, wd_norm, wd_embed, mult) for n in g["names"]}
    decay = {"default": wd, "norm": wd_norm, "embed": wd_embed, "zero": 0.0}
    seen, kinds = set(), set()
    for path, m in jax.tree_util.tree_flatten_with_path(markers["params"])[0]:
        c = classify_param(path)
        for i in np.unique(np.asarray(m)):
            name = names[int(i) - 1]
            if c["frozen"]:
                assert name.startswith("audio_backbone.") and name not in groups, name
                continue
            want = (mult if c["backbone"] else 1.0, decay[c["wd_kind"]])
            assert groups[name] == want, (name, jax.tree_util.keystr(path), groups[name], want)
            seen.add(name)
            if "backbone" in name:
                kinds.add((name.split(".")[0], c["wd_kind"]))
    assert seen == set(groups)
    assert {(t, k) for t in ("backbone", "pre_sam_backbone") for k in ("default", "norm")} <= kinds
    pvt_norms = {n for n in groups if n.startswith("backbone.") and ".norm" in n}
    assert {"backbone.patch_embed1.norm.weight", "backbone.block1.0.attn.norm.weight",
            "backbone.norm4.bias"} <= pvt_norms
    assert all(groups[n] == (mult, wd_norm) for n in pvt_norms)


@pytest.fixture(scope="module")
def train_oracle():
    """JAX: the PVT MaskFormer's training losses and gradients in float64,
    deterministic (no drop path, no dropout), and the criterion's draws.
    Port: the same in eval mode, from the same weights and draws."""
    port = init_weights(MaskFormer(**PVT_MODEL, device="cpu"), seed=5)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    kw = dict(dec_layers=HEAD["dec_layers"], enc_layers=HEAD["enc_layers"])
    jm = JaxMaskFormer(**PVT_MODEL, deterministic=True)
    batch = _batch(5)
    wd = build_weight_dict(dec_layers=HEAD["dec_layers"] + 1)
    key = jax.random.PRNGKey(3)
    N = batch["images"].shape[0] * T
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           jckpt.convert_combo_checkpoint(sd, backbone="pvt", **kw))
        jcrit = JaxSetCriterion(num_classes=2, matcher=JaxHungarianMatcher(num_points=MPTS),
                                num_points=NPTS, oversample_ratio=OS,
                                importance_sample_ratio=ISR, cosine_n_frame=T, exact_topk=True)
        inputs = [batch[k].astype(np.float64) for k in ("images", "audio_log_mel", "pre_masks")]
        targets = {"labels": batch["labels"].reshape(N, K),
                   "masks": batch["masks"].reshape(N, K, S, S),
                   "valid": batch["valid"].reshape(N, K)}
        fw = batch["gt_temporal_mask"].reshape(-1).astype(np.float64)

        def loss_fn(params):
            out = jm.apply({"params": params}, *inputs)
            losses = jcrit(key, out, jax.tree.map(jnp.asarray, targets),
                           frame_weight=jnp.asarray(fw))
            return jax_total_loss(losses, wd), losses

        (jtot, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        jlosses = {k: float(v) for k, v in jlosses.items()}
        draws = jax_draws(key, HEAD["dec_layers"] + 1, N, K)
        jgrads = jax.tree.map(np.asarray, jgrads)
    del v64
    # give back the executables and their buffers (about 3 GB resident for
    # this fp64 gradient of the B5-width towers on XLA's CPU backend)
    jax.clear_caches()
    gc.collect()
    net = port.double().eval()
    losses = compute_losses(net, _criterion(), batch, torch.Generator(),
                            draws=[tuple(map(torch.from_numpy, d)) for d in draws])
    tot = total_loss(losses, wd)
    tot.backward()
    gsd = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in net.named_parameters()}
    pgrads = jckpt.convert_combo_checkpoint(gsd, backbone="pvt", **kw)["params"]
    return dict(jtot=float(jtot), jlosses=jlosses, jgrads=jgrads, tot=float(tot.detach()),
                losses={k: float(v.detach()) for k, v in losses.items()}, grads=pgrads)


def test_train_losses_match_jax_fp64(train_oracle):
    o = train_oracle
    assert set(o["losses"]) == set(o["jlosses"]) and len(o["losses"]) == 11
    for k, want in o["jlosses"].items():
        assert abs(o["losses"][k] - want) <= LOSS_RTOL * max(1.0, abs(want)), (k, want)
    assert abs(o["tot"] - o["jtot"]) <= LOSS_RTOL * abs(o["jtot"])


def test_train_gradients_match_jax_fp64(train_oracle):
    """Per-leaf rel-L2 of the port's gradient (through the converter, the PVT
    blocks stacked again) against jax.value_and_grad of the same loss."""
    o = train_oracle
    jflat = jax.tree_util.tree_flatten_with_path(o["jgrads"])[0]
    pflat = jax.tree.leaves(o["grads"])
    assert jax.tree.structure(o["jgrads"]) == jax.tree.structure(o["grads"])
    total = np.sqrt(sum(np.sum(np.asarray(g) ** 2) for g in pflat))
    bad, pvt_leaves = [], 0
    for (path, gj), gp in zip(jflat, pflat):
        name = jax.tree_util.keystr(path)
        gj, gp = np.asarray(gj), np.asarray(gp)
        scale = max(np.linalg.norm(gj), np.linalg.norm(gp))
        if "audio_backbone" in name:
            assert scale == 0.0, name
            continue
        pvt_leaves += "block" in name and "backbone" in name and scale > 0
        err = np.linalg.norm(gj - gp)
        if err > GRAD_RL2 * scale + GRAD_FLOOR * total:
            bad.append(f"{name}: |diff| {err:.3e}, |g| {scale:.3e}, |all| {total:.3e}")
    assert not bad, "\n".join(bad)
    assert pvt_leaves >= 2 * 15  # both towers' block leaves carry a gradient


PVT_COMBO = ["avs_s4/COMBO_PVTV2B5_bs8_90k.yaml", "avs_s4/Test_COMBO_PVTV2B5_bs8_90k.yaml",
             "avs_ms3/COMBO_PVTV2B5_bs8_20k.yaml", "avs_ms3/Test_COMBO_PVTV2B5_bs8_20k.yaml",
             "avs_ss/COMBO_PVTV2B5_bs8_90k.yaml"]
PVT_BASELINES = ["avs_s4/PVT-AVSS4-SemanticSegmentation.yaml",
                 "avs_ms3/PVT-AVSMS3-SemanticSegmentation.yaml",
                 "avs_ss/PVT-AVSS-SemanticSegmentation.yaml"]


@pytest.mark.parametrize("name", PVT_COMBO)
def test_build_model_of_each_pvt_combo_config(name):
    """build_model of a shipped COMBO-PVTv2-B5 config, on the meta device:
    B5 towers at depths (3, 6, 40, 3), and the state-dict keys and shapes of
    the JAX build_model's model (its fields into the port's MaskFormer)."""
    path = os.path.join(CONFIGS, name)
    model = build_model(config.setup_cfg(path), device="meta")
    jm = jax_build_model(jax_config.setup_cfg(path))
    assert tuple(jm.pvt_depths) == (3, 6, 40, 3)
    assert [len(getattr(model.backbone, f"block{i}")) for i in range(1, 5)] == [3, 6, 40, 3]
    want = MaskFormer(**_port_kwargs(jm), device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(NotImplementedError, match="PVT.DROP_PATH_RATE"):
        build_model(config.setup_cfg(path, ["MODEL.PVT.DROP_PATH_RATE", "0.2"]), device="meta")


@pytest.mark.parametrize("name", PVT_BASELINES)
def test_pvt_baselines_without_pre_sam_still_raise(name):
    """The PVT bases (no pre-SAM tower, early fusion with no fused level)
    still raise: the port builds the model without the SEM tower now, but
    the JAX forward fails on their empty FUSED_BACKBONE_DIM, and the port
    names that key."""
    with pytest.raises(ValueError, match="MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM"):
        build_model(config.setup_cfg(os.path.join(CONFIGS, name)), device="meta")
