"""The JAX package's side of tests/test_torch_ddp.py, run in the test's own
process while the port's ranks run in theirs:

`draw`: the JAX step's criterion draws at the global batch's shape, saved
for the ranks. `step`: the JAX `make_train_step` on the whole global batch of
`tests/torch_ddp_worker.py` in float64, with SGD at rate 1 so that the
weights' change is the gradient (tests/test_torch_avss_train.py does the
same), from the key whose draws `draw` saved. `evaluations`: the JAX
`evaluate` of the worker's S4 and AVSS splits in float64, one video a batch.
Both start from the port's seeded tiny weights through
`convert_combo_checkpoint`.
"""

from __future__ import annotations

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax

import __graft_entry__ as graft
from combo_avs_tpu import config as jax_config
from combo_avs_tpu.config import get_cfg
from combo_avs_tpu.data import catalogs as jcatalogs
from combo_avs_tpu.losses.criterion import SetCriterion as JaxSetCriterion
from combo_avs_tpu.losses.matcher import HungarianMatcher as JaxHungarianMatcher
from combo_avs_tpu.train import train_step as jax_train_step
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.train_step import TrainState
from combo_avs_tpu.train.trainer import evaluate as jax_evaluate
from combo_avs_torch.data import catalogs
from combo_avs_torch.losses.criterion import build_weight_dict
from tests import torch_ddp_worker as w
from tests.test_torch_losses import ISR, MPTS, NPTS, OS, jax_draws

KEY = 4  # the JAX step's PRNG key


def tiny_jax_model(num_classes: int = 2):
    return graft._flagship_model(tiny=True).clone(num_classes=num_classes)


def _variables64(jm, fields: dict):
    sd = {k: v.numpy() for k, v in w.tiny_model(fields).state_dict().items()}
    variables = convert_combo_checkpoint(sd, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def draw(d: str, dec_layers: int) -> None:
    """The JAX step's criterion draws at the global batch's shape, float64
    as it draws them under x64, to DIR/jax_draws.npz."""
    with jax.enable_x64(True):
        _, km = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), 0))
        draws = jax_draws(km, dec_layers + 1, w.B * w.T, w.K)
    np.savez(os.path.join(d, "jax_draws.npz"),
             **{f"{j}_{i}": a for j, layer in enumerate(draws) for i, a in enumerate(layer)})


def step(fields: dict) -> tuple:
    """The JAX step casts the model's inputs to float32, its compute type on
    the chip, which rounds the normalized frames; here, in float64
    throughout, they are cast to float64, as tests/test_torch_train.py's
    oracle feeds them. Float64 masks and frame weights likewise (float32
    frame weights would make the class loss's weights float32). Returns the
    metrics (floats) and the gradient ({key path: array})."""
    jm = tiny_jax_model()
    wd = build_weight_dict(dec_layers=jm.dec_layers + 1)
    crit = JaxSetCriterion(num_classes=2, matcher=JaxHungarianMatcher(num_points=MPTS),
                           num_points=NPTS, oversample_ratio=OS, importance_sample_ratio=ISR,
                           cosine_n_frame=w.T, exact_topk=True)
    batch = w.global_batch()
    with jax.enable_x64(True):
        v64 = _variables64(jm, fields)
        opt = optax.sgd(1.0)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                           frozen=v64["frozen"], opt_state=opt.init(v64["params"]))
        jbatch = {k: jnp.asarray(v.astype(np.float64) if k in ("masks", "gt_temporal_mask")
                                 else v) for k, v in batch.items()}
        train_step = jax_train_step.make_train_step(jm, crit, wd, opt, donate=False)
        inputs64 = functools.partial(jax_train_step._model_inputs, dtype=jnp.float64)
        with mock.patch.object(jax_train_step, "_model_inputs",
                               lambda b, dtype=None: inputs64(b)):
            new_state, metrics = train_step(state, jbatch, jax.random.PRNGKey(KEY))
        grads = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda a, b: np.asarray(a) - np.asarray(b), state.params, new_state.params))[0]
    return ({k: float(v) for k, v in metrics.items()},
            {jax.tree_util.keystr(path): g for path, g in grads})


def evaluations(d: str, spec: dict) -> dict:
    """{split: the merged metrics}; `d` takes the AVSS config file."""
    from tests.test_torch_avss import AVSS_TEST, TINY_AVSS, _tiny_config

    w.register_splits(spec)
    for name in (w.S4_SPLIT, w.AVSS_SPLIT):
        jcatalogs.register(name, catalogs.DatasetCatalog[name],
                           dict(catalogs.MetadataCatalog[name]))
    s4_cfg = get_cfg()
    s4_cfg.INPUT.SIZE_DIVISIBILITY = w.S
    s4_cfg.MODEL.PRE_SAM.USE_PRE_SAM = True
    s4_cfg.TEST.BF16 = False
    s4_cfg.OUTPUT_DIR = ""
    avss_cfg = jax_config.setup_cfg(_tiny_config(d, AVSS_TEST, TINY_AVSS, "tiny_avss.yaml"))
    avss_cfg.defrost()
    avss_cfg.TEST.BF16 = False
    avss_cfg.OUTPUT_DIR = ""
    out = {}
    for name, cfg, classes in ((w.S4_SPLIT, s4_cfg, 2), (w.AVSS_SPLIT, avss_cfg, 71)):
        jm = tiny_jax_model(classes)
        with jax.enable_x64(True):
            v64 = _variables64(jm, dict(spec["fields"], num_classes=classes))
            out[name] = jax_evaluate(cfg, jm, v64["params"], v64["frozen"], name,
                                     batch_size=1)["sem_seg"]
        jax.clear_caches()
    return out
