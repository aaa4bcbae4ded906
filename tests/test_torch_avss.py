"""The port's AVSS benchmark against the JAX package on the CPU: the catalog
(`load_avss_records`, `register_all` under both dataset-root conventions),
the eval and training mappers (index labels, 12 target slots, no geometric
augmentation), `SemSegEvaluatorSS` inline, merged and through its per-video
partials, the evaluation entry point `pred --config-file` end to end on a
tiny 71-class model, the repaired `pred --config-file` on an MS3 config
without `--dataset`, and the Jonker-Volgenant assignment solver. The trees
are `data/synth.py::make_avss`'s at 32^2: v1s, v1m (5 frames) and v2 (10
frames) videos."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.optimize import linear_sum_assignment

import __graft_entry__ as graft
from combo_avs_tpu import config as jax_config
from combo_avs_tpu.data import catalogs as jcatalogs
from combo_avs_tpu.evaluation import evaluator as jevaluator
from combo_avs_tpu.ops.lsap import solve_lsap as jax_solve_lsap
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.trainer import build_mapper as jax_build_mapper
from combo_avs_tpu.train.trainer import evaluate as jax_evaluate
from combo_avs_torch import config, pred
from combo_avs_torch.data import catalogs
from combo_avs_torch.data.synth import make_avss, make_ms3
from combo_avs_torch.evaluation import evaluator
from combo_avs_torch.models import meta_arch
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.ops import lsap
from combo_avs_torch.train import checkpoint
from combo_avs_torch.train import evaluate as evaluate_mod
from combo_avs_torch.train.evaluate import evaluate
from combo_avs_torch.train.trainer import build_evaluator, build_mapper
from tests.test_torch_pvt import CONFIGS
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)
from tests.test_torch_trainer import TINY_RUN, _nested

S = 32
N_TRAIN, N_VAL, N_TEST = 3, 3, 3  # each split: one v1s, one v1m and one v2 video
AVSS_TRAIN = os.path.join(CONFIGS, "avs_ss", "COMBO_R50_bs8_90k.yaml")
AVSS_TEST = os.path.join(CONFIGS, "avs_ss", "Test_COMBO_R50_bs8_90k.yaml")
MS3_TEST = os.path.join(CONFIGS, "avs_ms3", "Test_COMBO_PVTV2B5_bs8_20k.yaml")
# the tiny run at 32^2 frames, 71 classes (the AVSS configs' own)
TINY_AVSS = TINY_RUN + ["INPUT.SIZE_DIVISIBILITY", str(S), "INPUT.CROP.SIZE", f"({S}, {S})"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic AVSS tree (3 train, 3 val, 3 test videos), registered in
    the port's catalog. It holds no S4 or MS3 split, so registering it in
    either package replaces no name that another test module registered."""
    root = str(tmp_path_factory.mktemp("avsstree"))
    avss = make_avss(root, N_TRAIN, N_VAL, N_TEST, size=S)
    catalogs.register_all(root)
    return root, avss


def _tiny_config(root, base, opts, name):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump({"_BASE_": base, **_nested(opts)}, f, sort_keys=False)
    return path


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("convention", ["parent", "avss_dir"])
def test_catalog_matches_jax(tree, split, convention):
    """Records equal the JAX package's (pandas) reading, key for key, under a
    parent root and under the AVSS directory itself; v1s and v1m videos have
    5 frames and v2 videos 10, a v1s train video keeps its first label only;
    the metadata is the AVSS evaluator's with the 71 class names."""
    root, avss = tree
    where = root if convention == "parent" else avss
    catalogs.register_all(where)
    jcatalogs.register_all(where)
    name = f"avss_sem_seg_{split}"
    got = catalogs.DatasetCatalog[name]()
    assert got == jcatalogs.DatasetCatalog[name]()
    assert got == jcatalogs.load_avss_records(avss, split, os.path.join(avss, "pre_SAM_mask"))
    assert [r["subset"] for r in got] == ["v1s", "v1m", "v2"]
    for rec in got:
        T = 10 if rec["subset"] == "v2" else 5
        assert rec["num_frames"] == len(rec["file_names"]) == len(rec["pre_mask_file_names"]) == T
        first_only = split == "train" and rec["subset"] == "v1s"
        assert len(rec["sem_seg_file_names"]) == (1 if first_only else T)
        assert rec["gt_temporal_mask_flag"] == ([1] + [0] * 4 if first_only else [1] * T)
    meta = catalogs.MetadataCatalog[name]
    assert meta == jcatalogs.MetadataCatalog[name]
    assert meta["evaluator_type"] == "sem_seg_ss" and len(meta["stuff_classes"]) == 71


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_mapper_matches_jax(tree, is_train):
    """The AVSS mapper of the shipped COMBO-R50 config, built by each
    package's `build_mapper`: the batches of every video are byte-equal to
    the JAX mapper's, eval and training (call n of the training mapper draws
    what the JAX mapper's n-th call draws: SSD colour and flip, no resize or
    crop); labels are class indices in 12 slots."""
    root, _ = tree
    catalogs.register_all(root)
    opts = ["INPUT.SIZE_DIVISIBILITY", str(S)]
    cfg, jcfg = config.setup_cfg(AVSS_TRAIN, opts), jax_config.setup_cfg(AVSS_TRAIN, opts)
    mapper = build_mapper(cfg, is_train=is_train)
    jmapper = jax_build_mapper(jcfg, is_train=is_train)
    assert (mapper.binary_gt, mapper.geometric_aug, mapper.max_instances) == (False, False, 12)
    for n, rec in enumerate(catalogs.DatasetCatalog["avss_sem_seg_train" if is_train
                                                   else "avss_sem_seg_val"]()):
        got = mapper(rec, n) if is_train else mapper(rec)
        want = jmapper(rec)  # the JAX mapper numbers its calls itself
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        T = rec["num_frames"]
        assert got["labels"].shape == (T, 12) and got["images"].shape == (T, S, S, 3)
        # the painted class and the background, in the slots of annotated frames
        assert set(got["labels"][got["valid"]].tolist()) <= {0, int(rec["video"][-4:]) % 70 + 1}


def test_evaluator_ss_matches_jax():
    """process, merge and evaluate of the AVSS evaluator, inline and through
    per-video partials (`eval_video_partial_ss`), with ignored pixels,
    equal the JAX ones; a class never present scores 0."""
    rng = np.random.RandomState(11)
    ports, jaxes = evaluator.SemSegEvaluatorSS(), jevaluator.SemSegEvaluatorSS()
    merged, jmerged = evaluator.SemSegEvaluatorSS(), jevaluator.SemSegEvaluatorSS()
    for T in (5, 10, 5):
        sem = rng.randn(T, 71, 16, 16).astype(np.float32)
        sem[:, [0, 3, 7, 70]] += 2.0  # mostly the labelled classes, some others
        gt = rng.choice([0, 3, 7, 70], size=(T, 16, 16)).astype(np.uint8)
        gt[:, 12:] = 255
        ports.process(sem, gt)
        jaxes.process(sem, gt)
        part = evaluator.eval_video_partial_ss(71, sem, gt, (12, 16), 24, 20)
        jpart = jevaluator.eval_video_partial("sem_seg_ss", 71, sem, gt, (12, 16), 24, 20)
        for a in ("_iou_pc", "_f_pc", "_cls_pc"):
            np.testing.assert_array_equal(getattr(part, a), getattr(jpart, a))
        merged.merge(part)
        jmerged.merge(jpart)
    got = ports.evaluate()
    assert got == jaxes.evaluate()
    assert set(got["sem_seg"]) == {"mIoU", "f_score", "mIoU_noBg", "f_score_noBg"}
    assert merged.evaluate() == jmerged.evaluate()
    assert merged._cls_pc.sum() > 0 and (merged._cls_pc == 0).any()  # classes never seen


def _tiny_avss_models():
    """The tiny flagship with AVSS's 71 classes: the JAX model and the port's
    seeded one on the same fields."""
    jm = graft._flagship_model(tiny=True).clone(num_classes=71)
    port = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0).eval()
    return jm, port


def test_pred_avss_matches_jax_evaluator(tree, tmp_path):
    """The AVSS evaluation entry point end to end: `pred --config-file` on a
    tiny COMBO-R50 AVSS Test config, without `--dataset` or `--bf16`, scores
    the config's split (avss_sem_seg_test, both frame buckets) in fp32
    (TEST.BF16 "auto" on the CPU) with the AVSS evaluator, and its metrics
    are the port's `evaluate` on the same model. In float64 on both sides
    the port's metrics equal the JAX package's `evaluate` (the fp32 maps of
    two frameworks may break an argmax tie apart; float64 ones do not)."""
    root, _ = tree
    catalogs.register_all(root)
    jcatalogs.register_all(root)
    cfg_path = _tiny_config(str(tmp_path), AVSS_TEST, TINY_AVSS, "tiny_avss.yaml")
    jm, port = _tiny_avss_models()
    ckpt = str(tmp_path / "model_best.pth")
    checkpoint.save_reference_checkpoint(port, ckpt)
    seen = []
    real = evaluate_mod.evaluate

    def recording(*args, **kw):
        seen.append((args[1], kw["bf16"], type(kw["evaluator"]).__name__))
        return real(*args, **kw)

    with mock.patch.object(evaluate_mod, "evaluate", recording):
        got = pred.main(["--datasets-root", root, "--checkpoint", ckpt, "--config-file",
                         cfg_path, "--batch-size", "2", "--output-dir", str(tmp_path / "out")])
    assert seen == [("avss_sem_seg_test", False, "SemSegEvaluatorSS")]
    assert os.path.isfile(tmp_path / "out" / "inference" / "avss_sem_seg_test" /
                          "sem_seg_evaluation.pth")
    assert set(got["sem_seg"]) == {"mIoU", "f_score", "mIoU_noBg", "f_score_noBg"}
    inline, timing = evaluate(port, "avss_sem_seg_test", batch_size=2, size=S)
    assert got == inline and timing["videos"] == N_TEST and timing["frames"] == 20

    jcfg = jax_config.setup_cfg(cfg_path)
    jcfg.defrost()
    jcfg.TEST.BF16 = False
    jcfg.OUTPUT_DIR = ""
    variables = convert_combo_checkpoint({k: v.numpy() for k, v in port.state_dict().items()},
                                         dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        want64 = jax_evaluate(jcfg, jm, v64["params"], v64["frozen"], "avss_sem_seg_test",
                              batch_size=2)
    cfg = config.setup_cfg(cfg_path)
    got64, _ = evaluate(port.double(), "avss_sem_seg_test", batch_size=2, size=S,
                        mapper=build_mapper(cfg, is_train=False),
                        evaluator=build_evaluator(cfg, "avss_sem_seg_test"))
    assert got64 == want64


def test_pred_ms3_config_without_dataset_scores_its_split(tmp_path, monkeypatch):
    """The repaired `pred --config-file`: given the shipped MS3 Test config
    (COMBO-PVTv2-B5, the tiny head, the towers at depths 1/1/1/1) and no
    `--dataset`, it scores the config's avsms3_sem_seg_test with the MS3
    evaluator, not the S4 split it used to default to."""
    root = str(tmp_path)
    make_ms3(root, 0, 0, size=S, n_test=2)
    assert config.setup_cfg(MS3_TEST).DATASETS.TEST == ("avsms3_sem_seg_test",)
    opts = [v for k, v in zip(TINY_AVSS[::2], TINY_AVSS[1::2]) if k not in (
        "MODEL.BACKBONE.NAME", "MODEL.PRE_SAM.PRE_SAM_DIM") for v in (k, v)]
    cfg_path = _tiny_config(root, MS3_TEST, opts, "tiny_ms3_test.yaml")
    monkeypatch.setattr(meta_arch, "PVT_DEPTHS", (1, 1, 1, 1))
    cfg = config.setup_cfg(cfg_path)
    ckpt = os.path.join(root, "model.pth")
    checkpoint.save_reference_checkpoint(init_weights(meta_arch.build_model(cfg), seed=0), ckpt)
    seen = []
    real = evaluate_mod.evaluate

    def recording(*args, **kw):
        seen.append((args[1], kw["bf16"], type(kw["evaluator"]).__name__))
        return real(*args, **kw)

    monkeypatch.setattr(evaluate_mod, "evaluate", recording)
    got = pred.main(["--datasets-root", root, "--checkpoint", ckpt, "--config-file", cfg_path,
                     "--output-dir", os.path.join(root, "out")])
    assert seen == [("avsms3_sem_seg_test", False, "SemSegEvaluator")]
    assert set(got["sem_seg"]) == {"mIoU", "f_score"}
    assert os.path.isdir(os.path.join(root, "out", "inference", "avsms3_sem_seg_test"))


def test_pred_overrides_and_refusals(tree, tmp_path, monkeypatch):
    """`--dataset` and `--bf16` override the config's splits and precision;
    without a config pred keeps its old defaults (COMBO-R50 S4 on
    avss4_sem_seg_test, fp32); a config with TEST.AUG.ENABLED is refused;
    TEST.EXPECTED_RESULTS is checked (`verify_results`)."""
    root, _ = tree
    catalogs.register_all(root)
    seen = []

    def fake(model, name, **kw):
        seen.append((name, kw["bf16"], type(kw.get("evaluator")).__name__))
        return {"sem_seg": {"mIoU": 0.25, "f_score": 0.5}}, {}

    monkeypatch.setattr(evaluate_mod, "evaluate", fake)
    monkeypatch.setattr(checkpoint, "load_reference_checkpoint", lambda model, path: None)
    cfg_path = _tiny_config(str(tmp_path), AVSS_TEST, TINY_AVSS, "tiny_avss.yaml")
    base = ["--datasets-root", root, "--checkpoint", "unused.pth"]
    pred.main(base + ["--config-file", cfg_path, "--dataset", "avss_sem_seg_val", "--bf16"])
    assert seen.pop() == ("avss_sem_seg_val", True, "SemSegEvaluatorSS")
    with monkeypatch.context() as m:
        m.setattr(meta_arch, "MaskFormer", lambda device=None: MaskFormer(
            **_port_kwargs(graft._flagship_model(tiny=True)), device="cpu"))
        # the default split, registered for this call only
        m.setitem(catalogs.DatasetCatalog, "avss4_sem_seg_test", lambda: [])
        m.setitem(catalogs.MetadataCatalog, "avss4_sem_seg_test", dict(catalogs.BINARY_METADATA))
        pred.main(base + ["--device", "cpu"])
    assert seen.pop() == ("avss4_sem_seg_test", False, "NoneType")
    aug = _tiny_config(str(tmp_path), AVSS_TEST, TINY_AVSS + ["TEST.AUG.ENABLED", "True"],
                       "aug.yaml")
    with pytest.raises(NotImplementedError, match="TEST.AUG.ENABLED"):
        pred.main(base + ["--config-file", aug])
    assert not seen
    real_setup = config.setup_cfg

    def expecting(path, opts=None, freeze=True):  # the scores evaluate() returns are 0.25, 0.5
        return real_setup(path, ["TEST.EXPECTED_RESULTS", "[['sem_seg', 'mIoU', 0.9, 0.01]]"],
                          freeze)

    monkeypatch.setattr(config, "setup_cfg", expecting)
    with pytest.raises(AssertionError, match="verification failed"):
        pred.main(base + ["--config-file", cfg_path])
    assert seen.pop()[0] == "avss_sem_seg_test"


# ---------------------------------------------------------------- Jonker-Volgenant
@pytest.fixture(scope="module")
def jax_jv():
    return jax.jit(jax.vmap(jax_solve_lsap))


@pytest.mark.parametrize("R", range(6, 17))
def test_jv_matches_jax_columns(jax_jv, R):
    """Random [N, R, 100] float32 costs (one optimum): the port's batched JV
    solver assigns the JAX solver's columns, and its total is scipy's."""
    rng = np.random.RandomState(R)
    cost = rng.rand(24, R, 100).astype(np.float32)
    cost[:4] *= 1e4  # the matcher's BIG_COST scale
    got = lsap.solve_lsap_batch(torch.from_numpy(cost)).numpy()
    assert got.shape == (24, R) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(jax_jv(jnp.asarray(cost))))
    for c, g in zip(cost, got):
        rows, cols = linear_sum_assignment(c)
        assert abs(float(c[np.arange(R), g].sum()) - float(c[rows, cols].sum())) <= \
            1e-6 * max(1.0, float(c[rows, cols].sum()))


@pytest.mark.parametrize("R", [6, 12, 16])
def test_jv_ties_match_jax_and_scipy(jax_jv, R):
    """Tie-heavy costs (a few integer levels, whole rows and columns of
    zeros): every assignment uses distinct columns, totals equal scipy's
    optimum, and the columns are the JAX solver's, exact ties included (the
    same nudge of assigned columns and the same first-index argmin)."""
    rng = np.random.RandomState(100 + R)
    cost = np.round(rng.rand(32, R, 100) * 3).astype(np.float32)
    cost[:, :, :R // 2] = 0.0
    cost[::4, :2] = 1.0
    cost[1::4] = 0.0  # all ties
    got = lsap.solve_lsap_batch(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_jv(jnp.asarray(cost))))
    for c, g in zip(cost, got):
        assert len(set(g.tolist())) == R
        rows, cols = linear_sum_assignment(c)
        assert float(c[np.arange(R), g].sum()) == float(c[rows, cols].sum())


@pytest.mark.parametrize("R", [5, 6])
def test_lsap_dispatch(R):
    """At most five rows take the closed form, more take JV (the JAX
    package's `solve_lsap_batch`); both solve the same problem."""
    cost = torch.from_numpy(np.random.RandomState(R).rand(4, R, 20).astype(np.float32))
    with mock.patch.object(lsap, "solve_lsap_jv", wraps=lsap.solve_lsap_jv) as jv, \
            mock.patch.object(lsap, "solve_lsap_small", wraps=lsap.solve_lsap_small) as small:
        got = lsap.solve_lsap_batch(cost)
    assert (small.call_count, jv.call_count) == ((1, 0) if R <= 5 else (0, 1))
    other = lsap.solve_lsap_jv(cost) if R <= 5 else None
    if other is not None:
        torch.testing.assert_close(got, other, rtol=0, atol=0)
