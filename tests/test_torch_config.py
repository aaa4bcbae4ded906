"""The PyTorch port's config reader and config-driven builders against the
JAX package on the CPU: every shipped YAML file read to the same tree (yaml
is the oracle here; the port reads the files without it), command-line
overrides, the repeated-key merge, the tags the port refuses, and
`build_model` / `build_criterion` / `build_weight_dict` / `build_optimizer`
from a config; the upstream forms the reader also takes (quoted scalars,
anchors and aliases, flow mappings, nested flow lists, the reference's eval
tag) against yaml with the JAX package's loader. Equality throughout: no
tolerance."""

import glob
import os
import random

import numpy as np
import pytest
import torch
import yaml

from combo_avs_tpu import config as jax_config
from combo_avs_tpu.models.meta_arch import build_model as jax_build_model
from combo_avs_tpu.losses.criterion import build_weight_dict as jax_build_weight_dict
from combo_avs_tpu.train.optim import warmup_poly_schedule as jax_schedule
from combo_avs_tpu.train.trainer import build_criterion as jax_build_criterion
from combo_avs_torch import config
from combo_avs_torch.losses.criterion import build_criterion, build_weight_dict
from combo_avs_torch.models.meta_arch import MaskFormer, build_model
from combo_avs_torch.train.optim import build_optimizer
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    REPO, _port_kwargs, one_torch_thread, release_worker_memory)

CONFIGS = sorted(glob.glob(os.path.join(REPO, "combo_avs_tpu", "configs", "*", "*.yaml")))
S4 = os.path.join(REPO, "combo_avs_tpu", "configs", "avs_s4", "COMBO_R50_bs8_90k.yaml")
# the tiny flagship's widths as config overrides (tests/test_trainer_loop.py's
# model, with the pre-SAM tower the port always builds)
TINY_OPTS = ["MODEL.BACKBONE.NAME", "tiny_resnet",
             "MODEL.PRE_SAM.PRE_SAM_DIM", "[32, 64, 128, 256]", "MODEL.AUDIO.WIDTH_MULT", "0.125",
             "MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM", "[32]",
             "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.MASK_FORMER.NHEADS", "2",
             "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64", "MODEL.MASK_FORMER.DEC_LAYERS", "3",
             "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8", "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
             "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1"]


def _without_device(d):
    d["MODEL"].pop("DEVICE")
    return d


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, os.path.dirname(
    os.path.dirname(p))))
def test_shipped_config_matches_jax(path):
    """The file read alone equals yaml's reading with the JAX package's
    loader, and the full config (defaults, _BASE_ chain, tuples) equals the
    JAX package's, MODEL.DEVICE aside ("cuda" in the port, "tpu" there)."""
    with open(path) as f:
        text = f.read()
    assert config.read_yaml(text) == yaml.load(text, Loader=jax_config._RefYamlLoader)
    port, ref = config.setup_cfg(path), jax_config.setup_cfg(path)
    assert port.MODEL.DEVICE == "cuda" and ref.MODEL.DEVICE == "tpu"
    assert _without_device(port.to_dict()) == _without_device(ref.to_dict())
    assert isinstance(port.DATASETS.TRAIN, tuple) and isinstance(port.INPUT.CROP.SIZE, tuple)


def test_overrides_and_repeated_keys_match_jax(tmp_path):
    """Command-line overrides (literals parsed, other strings kept) and a
    file whose mapping repeats a key (deep-merged), with a _BASE_ given by
    an absolute path, a flow list and an indented block sequence, as the
    JAX package reads them."""
    opts = ["SOLVER.MAX_ITER", "6", "MODEL.DEVICE", "cpu", "OUTPUT_DIR", "/tmp/x y",
            "INPUT.MIN_SIZE_TRAIN", "[64, 96]", "INPUT.CROP.SIZE", "(64, 64)",
            "MODEL.MASK_FORMER.EXACT_TOPK_POINTS", "True", "SEED", "-3", "TEST.BF16", "auto"]
    port, ref = config.setup_cfg(S4, opts), jax_config.setup_cfg(S4, opts)
    assert port.to_dict() == ref.to_dict()
    assert port.SOLVER.MAX_ITER == 6 and port.INPUT.CROP.SIZE == (64, 64)
    f = tmp_path / "tiny.yaml"
    f.write_text(f"_BASE_: {S4}\nMODEL:\n  MASK_FORMER:\n    DEC_LAYERS: 3  # a comment\n"
                 "  PIXEL_MEAN: [1.5, 2, 3e1, 4.]\nSOLVER:\n  MAX_ITER: 7\n"
                 "MODEL:\n  MASK_FORMER:\n    NHEADS: 2\n  PRE_SAM:\n    PRE_SAM_DIM:\n"
                 "      - 32\n      - 64\n# a comment line\nTEST:\n  EVAL_PERIOD: 2\n")
    port, ref = config.setup_cfg(str(f)), jax_config.setup_cfg(str(f))
    assert _without_device(port.to_dict()) == _without_device(ref.to_dict())
    mf = port.MODEL.MASK_FORMER
    assert (mf.DEC_LAYERS, mf.NHEADS, mf.HIDDEN_DIM) == (3, 2, 256)
    assert port.MODEL.PIXEL_MEAN == [1.5, 2, "3e1", 4.0]
    assert port.MODEL.PRE_SAM.PRE_SAM_DIM == [32, 64] and port.TEST.EVAL_PERIOD == 2
    with pytest.raises(AttributeError, match="frozen"):
        port.SOLVER.MAX_ITER = 1


# the YAML forms beyond the shipped files' subset that the reader takes:
# the reference's eval tag, anchors and aliases, quoted scalars and keys,
# flow mappings and nested flow collections
READ_FORMS = [
    "INPUT:\n  MIN_SIZE_TRAIN: !!python/object/apply:eval [\"[int(x * 0.1 * 224) for x in "
    "range(5, 21)]\"]\n",
    "INPUT:\n  MIN_SIZE_TRAIN: !!python/object/apply:eval\n  - \"[float(x) for x in range(3)]\"\n",
    "A: &anchor 1\nB: *anchor\n",
    "A: &m\n  x: 1\n  y: [1, {z: 'q'}]\nB: *m\nC:\n  - &s \"a\\tb\"\n  - *s\n",
    "A: &a [1, 2]\nB:\n  C: *a\n",
    "A: 'x'\n", 'A: "x"\n', "'A': 1\n", '"A B": \'it\'\'s\'\n',
    'A: "it\'s # not a comment"  # a comment\n', 'K: "\\u00e9\\x41 \\" \\\\"\n',
    "A: {b: 1}\n", "A: [[1], 2]\n", "A: {b: [1, 2, {c: d}], 'e f': \"g\", h: [[], {}]}\n",
    "A: {}\nB: []\nC: [ ]\nD: {a: , b: 1}\n",
    'MODEL:\n  FUSE_CONFIG:\n    TYPE: "MHA-S"\n    FUSED_BACKBONE: ["res2"]\n',
    "DATASETS:\n  TRAIN: ('avss4_sem_seg_train',)\n  TEST: \"('a', 'b')\"\n",
    "A: {x: 1}\nA: {y: {z: 2}}\nB:\n  C: 1\nB:\n  D: 2\n",
]


@pytest.mark.parametrize("text", READ_FORMS)
def test_yaml_forms_read_as_jax(text):
    """Each form reads to the tree that yaml with the JAX package's loader
    gives (repeated keys deep-merged, the eval tag evaluated), and a config
    file that uses it reads as the JAX package reads it."""
    want = yaml.load(text, Loader=jax_config._RefYamlLoader)
    got = config.read_yaml(text)
    assert repr(got) == repr(want)


def test_eval_tag_has_only_its_builtins():
    """The tag's expression sees no builtins but int, range and float, as in
    the JAX reader: anything else is a NameError on both sides."""
    text = "A: !!python/object/apply:eval [\"open('x')\"]\n"
    for read in (config.read_yaml, lambda t: yaml.load(t, Loader=jax_config._RefYamlLoader)):
        with pytest.raises(NameError, match="open"):
            read(text)


def test_config_file_with_upstream_forms_matches_jax(tmp_path):
    f = tmp_path / "up.yaml"
    f.write_text(f"_BASE_: {S4}\nMODEL:\n  FUSE_CONFIG:\n    TYPE: \"MHA-S\"\n"
                 "    FUSED_BACKBONE: &fb ['res2']\n  MASK_FORMER: {DEC_LAYERS: 4, NHEADS: 2}\n"
                 "INPUT:\n  MIN_SIZE_TRAIN: !!python/object/apply:eval [\"[int(x * 0.1 * 224) "
                 "for x in range(5, 21)]\"]\n  CROP: {SIZE: \"(64, 64)\"}\n"
                 "DATASETS:\n  TRAIN: ('avss4_sem_seg_train',)\n")
    port, ref = config.setup_cfg(str(f)), jax_config.setup_cfg(str(f))
    assert _without_device(port.to_dict()) == _without_device(ref.to_dict())
    assert port.MODEL.FUSE_CONFIG.TYPE == "MHA-S" and port.INPUT.CROP.SIZE == (64, 64)
    assert port.INPUT.MIN_SIZE_TRAIN == [int(x * 0.1 * 224) for x in range(5, 21)]


@pytest.mark.parametrize("text", [
    "A: !!python/name:os.system\n", "A: !custom 1\n", "A: !!str 1\n",
    "A: &x {a: 1}\nB:\n  <<: *x\n", "A: *missing\n", "A: 'x\n", 'A: "\\q"\n',
    "A: [1,\n  2]\n", "A: {a: 1\n", "A: |\n  x\n", "A: >\n  x\n",
    "A: 1\n---\nB: 2\n", "A: 0x1F\n", "A: 010\n", "A: .inf\n", "A: 1:30\n",
    "A:\n- - 1\n", "A:\n- b: 1\n", "A: b: c\n", "A: [a: 1]\n",
])
def test_refused_yaml_raises(text):
    """What the reader does not read raises by name, never misread: tags
    other than the reference's eval tag, merge keys, unknown aliases,
    unclosed or badly escaped quotes, multi-line flow collections, block
    scalars, several documents, the number forms other than decimal,
    compact sequences of sequences or mappings, mappings inside flow
    sequences. Each is YAML that PyYAML reads (or refuses too)."""
    with pytest.raises(ValueError, match="not read|not closed|bad escape|unknown YAML alias|"
                                         "malformed"):
        config.read_yaml(text)


class _ConfigDumper(yaml.SafeDumper):
    """safe_dump with lists of scalars in flow style and mappings in block
    style."""


_ConfigDumper.add_representer(list, lambda d, v: d.represent_sequence(
    "tag:yaml.org,2002:seq", v, flow_style=True))

_WORDS = ["a", "res2", "x y", "1e5", "b5", "MHA-B", "(1, 2)", "a#b", "late", "1.2.3",
          "pretrained/vggish-10086976.pth", "avss4_sem_seg_train", "-x", "a-b"]


def _rand_node(rng, depth):
    kind = rng.randrange(3) if depth < 4 else 2
    if kind == 0:
        return {rng.choice(["A", "B", "C_D", "e1", "x y"]): _rand_node(rng, depth + 1)
                for _ in range(rng.randint(1, 4))}
    if kind == 1:
        # a comma would need quotes in a flow list
        return [_rand_scalar(rng, [w for w in _WORDS if "," not in w])
                for _ in range(rng.randint(0, 4))]
    return _rand_scalar(rng, _WORDS)


def _rand_scalar(rng, words):
    pick = rng.randrange(5)
    if pick == 0:
        return rng.randint(-10 ** 6, 10 ** 6)
    if pick == 1:
        return rng.uniform(-1e3, 1e3)
    if pick == 2:
        return rng.choice([True, False, None, 1e-4, 1e20, 0.0, -0.5])
    return rng.choice(words)


@pytest.mark.parametrize("flow", [False, True], ids=["block", "mixed"])
def test_yaml_subset_round_trip(flow):
    """Random trees of mappings, lists and scalars in the subset, as
    `yaml.safe_dump` writes them (block style, as configs/_generate.py
    does, and with flow lists), read back as yaml.safe_load reads them."""
    rng = random.Random(0)
    for _ in range(400):
        doc = {"ROOT": _rand_node(rng, 0), "K": _rand_node(rng, 1)}
        text = yaml.dump(doc, Dumper=_ConfigDumper if flow else yaml.SafeDumper,
                         sort_keys=False, default_flow_style=False, width=10 ** 6)
        assert "'" not in text and '"' not in text, text  # the subset: nothing quoted
        assert repr(config.read_yaml(text)) == repr(yaml.safe_load(text)), text


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.basename(p))
def test_build_model_from_each_shipped_config(path):
    """For every shipped file: the port builds the model the JAX package's
    build_model describes (the same state-dict keys and shapes as
    MaskFormer(**the JAX model's fields)), or, for the
    12 `*-SemanticSegmentation.yaml` bases, raises ValueError naming
    FUSED_BACKBONE_DIM (early fusion with no fused level, on which the JAX
    forward fails)."""
    cfg = config.setup_cfg(path)
    jm = jax_build_model(jax_config.setup_cfg(path))
    if path.endswith("-SemanticSegmentation.yaml"):
        assert jm.fusion_step == "early" and not jm.fused_backbone_dim
        with pytest.raises(ValueError, match="MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM"):
            build_model(cfg, device="meta")
        return
    model = build_model(cfg, device="meta")
    want = MaskFormer(**_port_kwargs(jm), device="meta").state_dict()
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                          for k, v in want.items()}


def test_build_model_defaults_to_the_card():
    """MODEL.DEVICE "cuda" with no CUDA device raises; "cpu" builds there."""
    cfg = config.setup_cfg(S4, TINY_OPTS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    cpu = config.setup_cfg(S4, TINY_OPTS + ["MODEL.DEVICE", "cpu"])
    assert next(build_model(cpu).parameters()).device.type == "cpu"


def test_criterion_weights_and_optimizer_from_config():
    """build_weight_dict / build_criterion equal the JAX package's on the
    shipped S4 config and on one with other weights; build_optimizer takes
    SOLVER: its schedule equals the JAX one's, and its clip follows
    CLIP_GRADIENTS."""
    other = ["MODEL.MASK_FORMER.DEC_LAYERS", "4", "MODEL.MASK_FORMER.CLASS_WEIGHT", "1.5",
             "MODEL.MASK_FORMER.COSINE_WEIGHT", "0.0", "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64",
             "MODEL.MASK_FORMER.EXACT_TOPK_POINTS", "True"]
    for opts in ([], other):
        cfg, jcfg = config.setup_cfg(S4, opts), jax_config.setup_cfg(S4, opts)
        assert build_weight_dict(cfg) == jax_build_weight_dict(jcfg)
        port, ref = build_criterion(cfg), jax_build_criterion(jcfg)
        for f in ("num_classes", "eos_coef", "num_points", "oversample_ratio",
                  "importance_sample_ratio", "cosine_n_frame", "exact_topk"):
            assert getattr(port, f) == getattr(ref, f), f
        for f in ("cost_class", "cost_mask", "cost_dice", "num_points"):
            assert getattr(port.matcher, f) == getattr(ref.matcher, f), f
    assert build_weight_dict() == build_weight_dict(config.setup_cfg(S4))

    sched = ["SOLVER.WARMUP_ITERS", "10", "SOLVER.WARMUP_FACTOR", "0.1", "SOLVER.MAX_ITER", "50",
             "SOLVER.POLY_LR_CONSTANT_ENDING", "0.2"]
    model = build_model(config.setup_cfg(S4, TINY_OPTS + ["MODEL.DEVICE", "cpu"]))
    for opts in ([], sched, ["SOLVER.CLIP_GRADIENTS.ENABLED", "False"]):
        cfg, jcfg = config.setup_cfg(S4, opts), jax_config.setup_cfg(S4, opts)
        opt = build_optimizer(cfg, model)
        s = jcfg.SOLVER
        ref = jax_schedule(s.BASE_LR, s.MAX_ITER, s.WARMUP_ITERS, s.WARMUP_FACTOR, s.POLY_LR_POWER,
                           s.POLY_LR_CONSTANT_ENDING)
        for count in (0, 1, 5, 10, 30, 49, 50, 60):
            np.testing.assert_allclose(opt.schedule(count), float(ref(count)), rtol=1e-6)
        assert opt.clip_value == (0.01 if s.CLIP_GRADIENTS.ENABLED else 0.0)
    sgd = build_optimizer(config.setup_cfg(S4, ["SOLVER.OPTIMIZER", "SGD"]), model)
    assert type(sgd.inner).__name__ == "TraceSGD"
    assert {g["momentum"] for g in sgd.inner.param_groups} == {0.9}
    with pytest.raises(NotImplementedError, match="SOLVER.OPTIMIZER"):
        build_optimizer(config.setup_cfg(S4, ["SOLVER.OPTIMIZER", "LAMB"]), model)
    with pytest.raises(NotImplementedError, match="CLIP_TYPE"):
        build_optimizer(config.setup_cfg(S4, ["SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "value"]), model)
