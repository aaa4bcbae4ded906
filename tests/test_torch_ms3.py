"""The port's MS3 benchmark against the JAX package on the CPU: the catalog
(`load_avsms3_records`, `register_all` under both dataset-root conventions),
the evaluation entry point end to end on a tiny model, and `train_net` on an
MS3 COMBO-PVTv2-B5 config at cut depths, where every frame of a video is
annotated and weighted. The trees are `data/synth.py::make_ms3`'s at 64^2.
The AVSS COMBO models build here; the AVSS data path is held against the
JAX package in tests/test_torch_avss.py."""

import os

import jax
import numpy as np
import pytest
import yaml

import __graft_entry__ as graft
from combo_avs_tpu import config as jax_config
from combo_avs_tpu.data import catalogs as jcatalogs
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.trainer import evaluate as jax_evaluate
from combo_avs_torch import config, pred, train_net
from combo_avs_torch.data import catalogs
from combo_avs_torch.data.synth import make_ms3, make_s4
from combo_avs_torch.models import meta_arch
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer, build_model
from combo_avs_torch.train import checkpoint, train_step
from combo_avs_torch.train.evaluate import evaluate
from combo_avs_torch.train.trainer import Trainer, build_mapper
from tests.test_torch_pvt import CONFIGS
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)
from tests.test_torch_trainer import TINY_RUN, _nested, _rows

S = 64
N_TRAIN, N_VAL = 2, 3
# the S4 eval test's bound (tests/test_torch_eval.py::test_evaluate_matches_jax):
# fp32 maps that differ by rounding move a pixel only within that of the
# 0.5 threshold, and the metrics, rounded to 4 decimals, within 2e-3
METRIC_ATOL_FP32 = 2e-3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic MS3 tree (2 train, 3 val videos), registered in the port's
    catalog. It holds no S4 split, so registering it in either package
    replaces no S4 name that another test module registered."""
    root = str(tmp_path_factory.mktemp("ms3tree"))
    ms3 = make_ms3(root, N_TRAIN, N_VAL, size=S)
    catalogs.register_all(root)
    return root, ms3


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("convention", ["parent", "multi_sources"])
def test_catalog_matches_jax(tree, split, convention):
    """Records equal the JAX package's, key for key, under a parent root and
    under the reference's per-benchmark root (…/Multi-sources); every
    frame is annotated and weighted."""
    root, ms3 = tree
    where = root if convention == "parent" else os.path.join(root, "Multi-sources")
    catalogs.register_all(where)
    jcatalogs.register_all(where)
    got = catalogs.DatasetCatalog[f"avsms3_sem_seg_{split}"]()
    assert got == jcatalogs.DatasetCatalog[f"avsms3_sem_seg_{split}"]()
    assert got == jcatalogs.load_avsms3_records(ms3, split, os.path.join(ms3, "pre_SAM_mask"))
    assert len(got) == (N_TRAIN if split == "train" else N_VAL)
    for rec in got:
        assert len(rec["file_names"]) == len(rec["sem_seg_file_names"]) == 5
        assert len(rec["pre_mask_file_names"]) == 5
        assert rec["gt_temporal_mask_flag"] == [1] * 5 and "category" not in rec
    for name in ("avsms3_sem_seg_train", "avsms3_sem_seg_val", "avsms3_sem_seg_test"):
        assert catalogs.MetadataCatalog[name] == jcatalogs.MetadataCatalog[name]


def test_each_benchmark_keeps_its_own_roots(tmp_path, monkeypatch):
    """Registered under one root, S4 and MS3 records each take their own
    benchmark's frames and Maskiges (each split's loader binds its roots
    when it is registered). The registration goes into copies of the
    catalogs, which the test drops."""
    root = str(tmp_path)
    ms3, s4 = make_ms3(root, 0, 1, size=S), make_s4(root, 0, 1, size=S)
    monkeypatch.setattr(catalogs, "DatasetCatalog", dict(catalogs.DatasetCatalog))
    monkeypatch.setattr(catalogs, "MetadataCatalog", dict(catalogs.MetadataCatalog))
    catalogs.register_all(root)
    for bench, data in (("avss4", s4), ("avsms3", ms3)):
        for rec in catalogs.DatasetCatalog[f"{bench}_sem_seg_val"]():
            for key in ("file_names", "sem_seg_file_names", "pre_mask_file_names"):
                assert rec[key] and all(p.startswith(data + os.sep) for p in rec[key]), key


def _tiny_config(root, base, opts, name):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump({"_BASE_": os.path.join(CONFIGS, base), **_nested(opts)}, f,
                       sort_keys=False)
    return path


def test_pred_ms3_matches_jax_evaluator(tree, tmp_path):
    """The MS3 evaluation entry point end to end: `pred --config-file` on a
    tiny COMBO-R50 MS3 config (the tiny flagship's widths) reads a reference
    checkpoint and evaluates the synthetic MS3 val split; its metrics are
    the port's `evaluate` on the same model, and within the S4 eval test's
    bound of the JAX package's `evaluate` (fp32). In float64 on both sides
    the port's metrics equal the JAX package's."""
    root, _ = tree
    catalogs.register_all(root)
    jcatalogs.register_all(root)
    cfg_path = _tiny_config(str(tmp_path), "avs_ms3/COMBO_R50_bs8_20k.yaml", TINY_RUN,
                            "tiny_ms3.yaml")
    jm = graft._flagship_model(tiny=True)
    port = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0).eval()
    ckpt = str(tmp_path / "model_best.pth")
    checkpoint.save_reference_checkpoint(port, ckpt)
    got = pred.main(["--datasets-root", root, "--checkpoint", ckpt, "--config-file", cfg_path,
                     "--dataset", "avsms3_sem_seg_val", "--batch-size", "2",
                     "--output-dir", str(tmp_path / "out")])
    assert os.path.isfile(tmp_path / "out" / "inference" / "avsms3_sem_seg_val" /
                          "sem_seg_evaluation.pth")
    inline, timing = evaluate(port, "avsms3_sem_seg_val", batch_size=2, size=S)
    assert got == inline and timing["videos"] == N_VAL and timing["frames"] == 5 * N_VAL

    jcfg = jax_config.setup_cfg(cfg_path)
    jcfg.defrost()
    jcfg.TEST.BF16 = False
    jcfg.OUTPUT_DIR = ""
    variables = convert_combo_checkpoint({k: v.numpy() for k, v in port.state_dict().items()},
                                         dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    want = jax_evaluate(jcfg, jm, variables["params"], variables["frozen"],
                        "avsms3_sem_seg_val", batch_size=2)
    assert set(got["sem_seg"]) == set(want["sem_seg"]) == {"mIoU", "f_score"}
    for k, v in want["sem_seg"].items():
        assert abs(got["sem_seg"][k] - v) <= METRIC_ATOL_FP32, (k, got["sem_seg"][k], v)

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        want64 = jax_evaluate(jcfg, jm, v64["params"], v64["frozen"], "avsms3_sem_seg_val",
                              batch_size=2)
    got64, _ = evaluate(port.double(), "avsms3_sem_seg_val", batch_size=2, size=S)
    assert got64 == want64


@pytest.mark.parametrize("name", ["COMBO_PVTV2B5_bs8_20k.yaml", "COMBO_R50_bs8_20k.yaml"])
def test_train_net_ms3_weights_every_frame(tree, tmp_path, monkeypatch, name):
    """`train_net` on a shipped MS3 COMBO config with the tiny head (PVT:
    the config's B5 widths at depths 1/1/1/1; R50: the tiny flagship's
    backbone): two iterations, an evaluation and a checkpoint at 2; every
    training batch weights all five frames of each video, and each frame
    carries its target masks."""
    root, _ = tree
    pvt = "PVT" in name
    # the tiny run's head and data; the PVT model keeps the config's widths
    opts = [v for k, v in zip(TINY_RUN[::2], TINY_RUN[1::2]) if not pvt or k not in (
        "MODEL.BACKBONE.NAME", "MODEL.PRE_SAM.PRE_SAM_DIM") for v in (k, v)]
    opts += ["SOLVER.MAX_ITER", "2", "TEST.EVAL_PERIOD", "2", "SOLVER.CHECKPOINT_PERIOD", "2"]
    cfg_path = _tiny_config(str(tmp_path), f"avs_ms3/{name}", opts, "tiny_ms3.yaml")
    monkeypatch.setattr(meta_arch, "PVT_DEPTHS", (1, 1, 1, 1))
    seen = []
    real = train_step.compute_losses

    def recording(model, criterion, batch, generator, draws=None, amp=False):
        seen.append({k: np.asarray(batch[k]) for k in ("gt_temporal_mask", "valid")})
        assert model.training and not amp  # the PVT towers' drop path draws; MS3 is fp32
        return real(model, criterion, batch, generator, draws, amp=amp)

    monkeypatch.setattr(train_step, "compute_losses", recording)
    out = str(tmp_path / "out")
    trainer = train_net.main(["--config-file", cfg_path, "--datasets-root", root, "--log-every",
                              "1", "OUTPUT_DIR", out])
    assert isinstance(trainer, Trainer)
    if pvt:
        assert [len(getattr(trainer.model.backbone, f"block{i}")) for i in range(1, 5)] == [1] * 4
    assert trainer.cfg.DATASETS.TRAIN == ("avsms3_sem_seg_train",)
    assert len(seen) == 2
    for b in seen:
        assert b["gt_temporal_mask"].shape == (2, 5) and (b["gt_temporal_mask"] == 1).all()
        assert b["valid"].any(-1).all()  # every frame of every video has a target
    rows = _rows(trainer.metrics_file)
    assert [r["iter"] for r in rows if "total_loss" in r] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in rows if "total_loss" in r)
    assert [r["iter"] for r in rows if "mIoU" in r] == [2]
    assert {"step_2", "model_best.pth"} <= set(os.listdir(out))
    assert os.path.isfile(os.path.join(out, "inference", "avsms3_sem_seg_val",
                                       "sem_seg_evaluation.pth"))


@pytest.mark.parametrize("name", ["COMBO_R50_bs8_90k.yaml", "COMBO_PVTV2B5_bs8_90k.yaml"])
def test_avss_model_builds_and_its_data_path_still_raises(name):
    """The model of a shipped avs_ss COMBO config builds (71 classes and the
    no-object one), and since AVSS was ported its data path no longer
    raises: the mapper reads index labels into 12 slots with no geometric
    augmentation (tests/test_torch_avss.py holds it against the JAX
    mapper); a mapper name the port does not have still raises."""
    cfg = config.setup_cfg(os.path.join(CONFIGS, "avs_ss", name))
    assert build_model(cfg, device="meta").sem_seg_head.predictor.class_embed.out_features == 72
    mapper = build_mapper(cfg, is_train=True)
    assert (mapper.binary_gt, mapper.geometric_aug, mapper.max_instances) == (False, False, 12)
    other = config.setup_cfg(os.path.join(CONFIGS, "avs_ss", name),
                             ["INPUT.DATASET_MAPPER_NAME", "mask_former_semantic"])
    with pytest.raises(NotImplementedError, match="mask_former_semantic"):
        build_mapper(other, is_train=True)
