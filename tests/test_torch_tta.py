"""The port's test-time augmentation and prediction dumps against the JAX
package on the CPU: `make_tta_eval_step` (multi-scale and flip, the JAX
resize's weights) against JAX's in float64 on identical weights, the
single-scale step against `make_eval_step`, the flip symmetry and the
MIN_SIZES refusal; `evaluate()` with the TTA settings against the JAX
`evaluate` with TEST.AUG.ENABLED; `pred --config-file ... --save-vis
TEST.AUG.ENABLED True` and `Trainer.test(vis_dir=)`, whose PNGs hold the
argmax of each prediction as the JAX `save_prediction_vis` writes it; the
palettes. The JAX TTA step runs its own Python body with the model's
`apply` jitted, in float64: one compile per scale (not one of all four
branches together), which the JAX `evaluate` reuses."""

import copy
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from combo_avs_tpu.config import get_cfg
from combo_avs_tpu.data import catalogs as jcatalogs
from combo_avs_tpu.evaluation import visual as jvisual
from combo_avs_tpu.train import trainer as jtrainer
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.train_step import make_tta_eval_step as jax_make_tta_eval_step
from combo_avs_torch import config, pred
from combo_avs_torch.data import catalogs
from combo_avs_torch.data.png import read_png
from combo_avs_torch.data.synth import make_s4
from combo_avs_torch.evaluation import visual
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer, build_model
from combo_avs_torch.train import checkpoint
from combo_avs_torch.train import evaluate as evaluate_mod
from combo_avs_torch.train.evaluate import evaluate, eval_settings, save_prediction_vis
from combo_avs_torch.train.train_step import (make_eval_step, make_tta_eval_step,
                                              resize_frames, resize_weights)
from combo_avs_torch.train.trainer import Trainer
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)
from tests.test_torch_trainer import TINY_RUN

S = 64
SCALES = [32, 64]
N_VAL = 2  # videos of the tree, evaluated one a batch: the step test's batch shape
SPLIT = "tta_s4_val"
S4_TEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "combo_avs_tpu", "configs", "avs_s4", "Test_COMBO_R50_bs8_90k.yaml")


@pytest.fixture(scope="module")
def tiny():
    """The tiny flagship with one decoder layer (each JAX compile of it is a
    quarter shorter): the JAX model, the port's seeded model, and the JAX
    variables in float64 made from the port's weights."""
    jm = graft._flagship_model(tiny=True).clone(dec_layers=1)
    port = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0).eval()
    variables = convert_combo_checkpoint({k: v.numpy() for k, v in port.state_dict().items()},
                                         dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    return jm, port, v64


class _JitApply:
    """Stands in for the JAX model inside its TTA step: the step's body
    calls only `model.apply`, here jitted once per input shape."""

    def __init__(self, model):
        self.apply = jax.jit(model.apply)


@pytest.fixture(scope="module")
def jax_tta(tiny):
    """JAX's TTA step at SCALES with flip: `make_tta_eval_step`'s body run
    op by op (`__wrapped__`, the function it jits) around the jitted apply,
    whose two compiles (one per scale, in float64 at the evaluate batch's
    shapes) are the module's."""
    model = _JitApply(tiny[0])
    step = jax_make_tta_eval_step(model, scales=SCALES, flip=True, out_size=(S, S)).__wrapped__
    step.apply = model.apply
    return step


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic S4 tree (2 val videos at 64^2), registered in both
    packages' catalogs as SPLIT, a name no other module uses."""
    root = str(tmp_path_factory.mktemp("ttatree"))
    s4 = make_s4(root, 0, N_VAL, size=S)
    pre = os.path.join(s4, "pre_SAM_mask")
    catalogs.register(SPLIT, lambda: catalogs.load_avss4_records(s4, "val", pre),
                      dict(catalogs.BINARY_METADATA))
    jcatalogs.register(SPLIT, lambda: jcatalogs.load_avss4_records(s4, "val", pre),
                       {"evaluator_type": "sem_seg"})
    return root, s4


def _batch(seed, b=1, t=5, s=S):
    """A loader-format batch (the eval loader's keys, types and shapes)."""
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randint(0, 256, (b, t, s, s, 3)).astype(np.uint8),
        "audio_log_mel": rng.randn(b, t, 96, 64).astype(np.float32),
        "pre_masks": rng.randint(0, 256, (b, t, s, s, 3)).astype(np.uint8),
        "vid_temporal_mask": np.ones((b, t), np.float32),
    }


def _port64(port):
    net = copy.deepcopy(port)
    return net.double().eval()


@pytest.mark.parametrize("n_in,n_out", [(224, 128), (224, 384), (64, 32), (96, 224)])
def test_resize_weights_are_jax_s(n_in, n_out):
    """The resize's weight matrix is the one `jax.image.resize(...,
    "bilinear")` applies (read off as its resize of the identity), in
    float64 and in float32 arithmetic; in float64 the resized frames equal
    JAX's to rounding."""
    with jax.enable_x64(True):
        want = np.asarray(jax.image.resize(np.eye(n_in), (n_in, n_out), "bilinear"))
        x = np.random.RandomState(n_out).rand(1, 2, n_in, n_in, 3) * 255
        resized = np.asarray(jax.image.resize(x, (1, 2, n_out, n_out, 3), "bilinear"))
    np.testing.assert_allclose(resize_weights(n_in, n_out, np.float64), want, rtol=0,
                               atol=1e-15)
    want32 = np.asarray(jax.image.resize(np.eye(n_in, dtype=np.float32), (n_in, n_out),
                                         "bilinear"))
    # float32: one ulp below 1 apart at most (XLA's order of the column sums)
    np.testing.assert_allclose(resize_weights(n_in, n_out, np.float32), want32, rtol=0,
                               atol=6e-8)
    got = resize_frames(torch.from_numpy(x), n_out).numpy()
    np.testing.assert_allclose(got, resized, rtol=0, atol=1e-10)


def test_tta_step_matches_jax_fp64(tiny, jax_tta):
    """Scales [32, 64] with flip, in float64 on both sides (the JAX step
    casts the frames to float32 before its resize), against the JAX step on
    the same weights: atol and rtol 1e-6, the fp64 slice's bound."""
    jm, port, v64 = tiny
    batch = _batch(3)
    with jax.enable_x64(True):
        want = np.asarray(jax_tta(v64["params"], v64["frozen"], batch))
    got = make_tta_eval_step(_port64(port), SCALES, True, (S, S))(batch)
    assert got.shape == (5, 2, S, S)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_tta_single_scale_no_flip_is_the_eval_step(tiny, bf16):
    """At the frames' own size without flip the TTA step is the plain eval
    step, bit for bit, in either precision."""
    port = tiny[1]
    batch = _batch(4, b=1, t=2)
    want = make_eval_step(port, (S, S), bf16=bf16)(batch)
    got = make_tta_eval_step(port, [S], False, (S, S), bf16=bf16)(batch)
    assert torch.equal(got, want)


@pytest.mark.parametrize("scales", [[S], [32, S]], ids=["own_size", "two_scales"])
def test_tta_flip_symmetry(tiny, scales):
    """With flip, TTA of the mirrored frames is the mirror of TTA, with the
    network in float64: exactly at the frames' own size (the same two maps
    summed), within 1e-6 (the maps are float32) where a resize's samples
    sit a rounding off the mirror's."""
    batch = _batch(5, b=1, t=2)
    mirrored = dict(batch, images=batch["images"][:, :, :, ::-1].copy(),
                    pre_masks=batch["pre_masks"][:, :, :, ::-1].copy())
    step = make_tta_eval_step(_port64(tiny[1]), scales, True, (S, S))
    a, b = step(batch), step(mirrored).flip(-1)
    if scales == [S]:
        assert torch.equal(a, b)
    else:
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_tta_refuses_sizes_not_divisible_by_32(tiny):
    with pytest.raises(ValueError, match="MIN_SIZES entries must be divisible by 32"):
        make_tta_eval_step(tiny[1], [224, 100], True, (S, S))


def test_evaluate_with_tta_matches_jax(tiny, jax_tta, tree, monkeypatch):
    """evaluate() with a config's TEST.AUG settings and the JAX evaluate with
    TEST.AUG.ENABLED, both in float64 on the same weights over the 2
    synthetic videos: the same mIoU and F-score (to 1e-9)."""
    jm, port, v64 = tiny
    cfg = get_cfg()
    cfg.INPUT.SIZE_DIVISIBILITY = S
    cfg.MODEL.PRE_SAM.USE_PRE_SAM = True
    cfg.TEST.BF16 = False
    cfg.TEST.AUG.ENABLED = True
    cfg.TEST.AUG.MIN_SIZES = SCALES
    cfg.TEST.AUG.FLIP = True
    cfg.OUTPUT_DIR = ""

    def same_step(model, scales, flip, out_size, bf16):
        assert (list(scales), flip, tuple(out_size), bf16) == (SCALES, True, (S, S), False)
        return jax_tta

    monkeypatch.setattr(jtrainer, "make_tta_eval_step", same_step)
    with jax.enable_x64(True):
        want = jtrainer.evaluate(cfg, jm, v64["params"], v64["frozen"], SPLIT, batch_size=1)
    assert jax_tta.apply._cache_size() == 2  # the step test's compiles, reused
    pcfg = config.setup_cfg(None, ["INPUT.SIZE_DIVISIBILITY", str(S), "TEST.AUG.ENABLED", "True",
                                   "TEST.AUG.MIN_SIZES", str(SCALES), "TEST.BF16", "False"])
    settings = eval_settings(pcfg, torch.device("cpu"))
    assert settings == {"size": S, "bf16": False, "tta": {"scales": SCALES, "flip": True}}
    got, timing = evaluate(_port64(port), SPLIT, batch_size=1, **settings)
    assert timing["videos"] == N_VAL
    assert set(got["sem_seg"]) == set(want["sem_seg"]) == {"mIoU", "f_score"}
    for k, v in want["sem_seg"].items():
        assert abs(got["sem_seg"][k] - v) <= 1e-9, (k, got["sem_seg"][k], v)


def _png_pixels(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def test_pred_save_vis_with_tta_overrides(tree, tmp_path, monkeypatch):
    """`pred --config-file Test_COMBO_R50 --save-vis TEST.AUG.ENABLED True
    ...` (tiny widths as overrides too) scores the split with TTA and writes
    one PNG per frame to <out>/vis/<split>: each holds the binary palette
    at the argmax of the prediction evaluate() scored, and equals, pixel for
    pixel, the PNG the JAX `save_prediction_vis` writes for it."""
    root, _ = tree
    # the split is the module's; the tree's S4 names stay other modules'
    monkeypatch.setattr(catalogs, "register_all", lambda datasets_root: None)
    opts = TINY_RUN + ["TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "[32]"]
    model = init_weights(build_model(config.setup_cfg(S4_TEST, opts)), seed=1)
    ckpt = str(tmp_path / "model_best.pth")
    checkpoint.save_reference_checkpoint(model, ckpt)
    dumped, seen = [], []
    real_vis, real_eval = evaluate_mod.save_prediction_vis, evaluate_mod.evaluate

    def recording_vis(vis_dir, video, p):
        dumped.append((video, p.copy()))
        real_vis(vis_dir, video, p)

    def recording_eval(*args, **kw):
        seen.append(kw["tta"])
        return real_eval(*args, **kw)

    monkeypatch.setattr(evaluate_mod, "save_prediction_vis", recording_vis)
    monkeypatch.setattr(evaluate_mod, "evaluate", recording_eval)
    out = tmp_path / "out"
    res = pred.main(["--datasets-root", root, "--checkpoint", ckpt, "--config-file", S4_TEST,
                     "--dataset", SPLIT, "--batch-size", "2", "--output-dir",
                     str(out), "--save-vis", *opts])
    assert set(res["sem_seg"]) == {"mIoU", "f_score"}
    assert seen == [{"scales": [32], "flip": True}]
    vis = out / "vis" / SPLIT
    assert sorted(os.listdir(vis)) == sorted(f"{v}_{t}.png" for v, _ in dumped for t in range(5))
    assert len(dumped) == N_VAL
    jdir = tmp_path / "jax_vis"
    jdir.mkdir()
    palette = visual.binary_color_map()
    for video, p in dumped:
        assert p.shape == (5, 2, S, S)
        jtrainer.save_prediction_vis(str(jdir), video, p)
        for t in range(5):
            ours = read_png(str(vis / f"{video}_{t}.png"))
            np.testing.assert_array_equal(ours, palette[p[t].argmax(0)])
            np.testing.assert_array_equal(ours, _png_pixels(str(jdir / f"{video}_{t}.png")))


def test_trainer_test_vis_dir(tree, tmp_path):
    """Trainer.test(vis_dir=) evaluates with the config's TTA and dumps one
    PNG per frame; its metrics are evaluate()'s with the same settings."""
    cfg = config.setup_cfg(S4_TEST, TINY_RUN + [
        "TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "[64]", "TEST.AUG.FLIP", "False",
        "OUTPUT_DIR", str(tmp_path / "run")])
    trainer = Trainer(cfg)
    got = trainer.test(SPLIT, vis_dir=str(tmp_path / "vis"))
    assert len(os.listdir(tmp_path / "vis")) == N_VAL * 5
    want, _ = evaluate(trainer.model, SPLIT, batch_size=1, size=S, bf16=False,
                       tta={"scales": [64], "flip": False})
    assert got == want


@pytest.mark.parametrize("C", [2, 71])
def test_palettes_and_vis_match_jax(tmp_path, C):
    """`v2_pallete` draws JAX's colours; `save_prediction_vis` writes the
    JAX package's pixels for a binary and a 71-class prediction."""
    np.testing.assert_array_equal(visual.v2_pallete(C), jvisual.v2_pallete(C))
    np.testing.assert_array_equal(visual.binary_color_map(), jvisual.binary_color_map())
    pred_ = np.random.RandomState(C).rand(3, C, 17, 23).astype(np.float32)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    save_prediction_vis(str(tmp_path / "p"), "vid", pred_)
    jtrainer.save_prediction_vis(str(tmp_path / "j"), "vid", pred_)
    for t in range(3):
        np.testing.assert_array_equal(read_png(str(tmp_path / "p" / f"vid_{t}.png")),
                                      _png_pixels(str(tmp_path / "j" / f"vid_{t}.png")))
