"""The PyTorch port's training data path and pretrained importers against
the JAX package on the CPU:

* the training mapper on `data/synth.py` records (the shipped S4 recipe's
  augmentation: short sides 112-448, a 224 crop, SSD colour, flip) against
  the JAX mapper with the same (seed, call number): every output array
  equal;
* the first three `TrainLoader` batches against the JAX `TrainLoader`'s at
  seed 0 with one worker (where the JAX mapper's call order is fixed):
  equal; the port's batches do not depend on its worker count, and another
  seed gives another order;
* synthetic Caffe2-style and d2-style R-50 pickles and a synthetic VGGish
  `.pth` through the port's `load_pretrained` and through the JAX package's
  `convert_resnet` / `fan_out_siamese` / `convert_vggish`, compared through
  `state_dict_from_flax`: equal.
"""

import pickle

import numpy as np
import pytest
import torch

from combo_avs_tpu import config as jax_config
from combo_avs_tpu.data.catalogs import load_avss4_records as jax_records
from combo_avs_tpu.data.loader import TrainLoader as JaxTrainLoader
from combo_avs_tpu.train import checkpoint as jax_ckpt
from combo_avs_tpu.train.trainer import build_mapper as jax_build_mapper
from combo_avs_torch import config
from combo_avs_torch.data.catalogs import load_avss4_records
from combo_avs_torch.data.loader import TrainLoader
from combo_avs_torch.data.synth import make_s4
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.train.checkpoint import load_pretrained, state_dict_from_flax
from combo_avs_torch.train.trainer import build_mapper
from tests.test_torch_config import S4
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    _port_kwargs, one_torch_thread, release_worker_memory)

import __graft_entry__ as graft

FRAME = 96  # synthetic frames; the recipe resizes them to a short side of 112-448


@pytest.fixture(scope="module")
def s4_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("s4_train"))
    s4 = make_s4(root, n_train=5, n_val=0, size=FRAME)
    pre = f"{s4}/pre_SAM_mask"
    port, ref = load_avss4_records(s4, "train", pre), jax_records(s4, "train", pre)
    assert port == ref
    return port


def _mappers(seed=0):
    cfg, jcfg = config.setup_cfg(S4), jax_config.setup_cfg(S4)
    return build_mapper(cfg, is_train=True, seed=seed), jax_build_mapper(jcfg, is_train=True)


def test_training_mapper_matches_jax(s4_tree):
    """Six calls over the records (six different transforms, with and
    without each colour sub-op) give the JAX mapper's arrays."""
    port, ref = _mappers()
    assert (port.min_sizes, port.max_size, port.crop_size, port.color_aug) == (
        tuple(ref.min_sizes), ref.max_size, ref.crop_size, ref.color_aug)
    for n in range(6):
        rec = s4_tree[n % len(s4_tree)]
        want = ref(rec)  # the JAX mapper's n-th call
        got = port(rec, n)
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"call {n}: {k}")
    with pytest.raises(ValueError, match="call number"):
        port(s4_tree[0])


def _batches(loader, n=3):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def test_train_loader_matches_jax(s4_tree):
    port_mapper, ref_mapper = _mappers()
    want = _batches(JaxTrainLoader(s4_tree, ref_mapper, batch_size=2, seed=0, num_workers=1))
    got = _batches(TrainLoader(s4_tree, port_mapper, batch_size=2, seed=0, num_workers=1))
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"batch {i}: {k}")
    # the call numbers follow the stream, so more workers give the same batches
    more = _batches(TrainLoader(s4_tree, _mappers()[0], batch_size=2, seed=0, num_workers=3))
    for g, m in zip(got, more):
        for k in g:
            np.testing.assert_array_equal(m[k], g[k])


def test_train_loader_seed_and_failures(s4_tree):
    """Another seed, another order (the JAX trainer passes none, so its order
    is always seed 0's); a mapper failure is raised by next()."""
    names = {r["video"]: i for i, r in enumerate(s4_tree)}

    def order(seed):
        def mapper(rec, n):
            return {"video": np.int32(names[rec["video"]])}
        return [b["video"].tolist() for b in _batches(
            TrainLoader(s4_tree, mapper, batch_size=2, seed=seed, num_workers=2), 6)]

    assert order(0) == order(0)
    assert order(0) != order(1)

    def broken(rec, n):
        raise OSError("unreadable frame")

    loader = TrainLoader(s4_tree, broken, batch_size=2)
    with pytest.raises(OSError, match="unreadable"):
        next(loader)
    loader.close()


_CAFFE2_BRANCH = {"shortcut": "branch1", "conv1": "branch2a", "conv2": "branch2b",
                  "conv3": "branch2c"}


def _caffe2_name(key):
    """A tower key -> its MSRA / Caffe2 name (None: not in such files)."""
    parts = key.split(".")
    if parts[0] == "stem":
        if parts[-1] == "weight" and len(parts) == 3:
            return "conv1_w"
        return {"weight": "res_conv1_bn_s", "bias": "res_conv1_bn_b"}.get(parts[-1])
    stage, block, conv = parts[:3]
    base = f"{stage}_{block}_{_CAFFE2_BRANCH[conv]}"
    if len(parts) == 4:
        return f"{base}_w"
    return {"weight": f"{base}_bn_s", "bias": f"{base}_bn_b"}.get(parts[-1])


@pytest.mark.parametrize("style", ["caffe2", "d2"])
def test_pretrained_import_matches_jax(tmp_path, style):
    jm = graft._flagship_model(tiny=True)
    kw = dict(dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    model = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0)
    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(1)
    tower = {k[len("backbone."):]: rng.randn(*v.shape).astype(np.float32)
             for k, v in before.items() if k.startswith("backbone.")}
    if style == "caffe2":
        sd = {_caffe2_name(k): v for k, v in tower.items() if _caffe2_name(k)}
        sd["fc1000_w"] = rng.randn(4, 8).astype(np.float32)
        path = tmp_path / "R-50.pkl"
        with open(path, "wb") as f:
            pickle.dump(sd, f)
    else:
        sd = {**{k: torch.from_numpy(v) for k, v in tower.items()},
              "stem.conv1.norm.num_batches_tracked": torch.tensor(3),
              "res2.0.conv1.norm.num_batches_tracked": torch.tensor(3),
              "fc.weight": torch.zeros(4, 8)}
        path = tmp_path / "d2_r50.pth"
        torch.save({"model": sd}, path)
    vgg = {k[len("audio_backbone."):]: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
           for k, v in before.items() if k.startswith("audio_backbone.")}
    vgg_path = tmp_path / "vggish.pth"
    torch.save(vgg, vgg_path)

    load_pretrained(model, str(path), str(vgg_path))

    variables = jax_ckpt.convert_combo_checkpoint(before, **kw)
    bp, bf, pp, pf = jax_ckpt.fan_out_siamese(jax_ckpt.convert_resnet(
        jax_ckpt.load_torch_file(str(path))))
    variables["params"].update(backbone=bp, pre_sam_backbone=pp,
                               audio_backbone=jax_ckpt.convert_vggish(
                                   jax_ckpt.load_torch_file(str(vgg_path))))
    variables["frozen"].update(backbone=bf, pre_sam_backbone=pf)
    want = state_dict_from_flax(variables, **kw)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    changed = {k for k in got if not np.array_equal(got[k].numpy(), before[k])}
    assert {k.split(".")[0] for k in changed} == {"backbone", "pre_sam_backbone",
                                                   "audio_backbone"}

    missing = tmp_path / "absent.pkl"
    load_pretrained(model, str(missing), str(tmp_path / "absent.pth"))  # logged, skipped
    if style == "d2":
        del sd["res2.0.conv2.weight"]
        torch.save({"model": sd}, path)
        with pytest.raises(ValueError, match="missing keys"):
            load_pretrained(model, str(path))
