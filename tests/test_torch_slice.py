"""The PyTorch port's first slice, COMBO-R50 S4 inference, against the JAX
package on the CPU.

Weights come from the port's seeded init and go through the JAX package's
`convert_combo_checkpoint` into the JAX model, so both forwards run identical
weights on identical numpy inputs. The port's `state_dict_from_flax` must
invert that converter exactly."""

import ctypes
import gc
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from combo_avs_tpu.models.meta_arch import MaskFormer as JaxMaskFormer
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint
from combo_avs_tpu.train.train_step import make_eval_step as jax_make_eval_step
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.train.checkpoint import state_dict_from_flax
from combo_avs_torch.train.train_step import make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's constructor takes the JAX model's field names
PORT_FIELDS = ("backbone_name", "num_classes", "num_queries", "hidden_dim", "nheads",
               "dim_feedforward", "dec_layers", "enc_layers", "mask_dim", "conv_dim",
               "audio_dim", "audio_out_dim", "pre_sam_dim", "vggish_width")
B, T, S = 1, 2, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run torch on one thread: their tensors are small
    (the wall time is the same), and the suite's other workers need the
    cores. The other test_torch_*.py files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def release_worker_memory():
    """After each port test module, give back what it held: its JAX
    executables, its garbage, and the heap pages glibc keeps after the
    arrays are freed. The tier-1 suite's workers each run many modules, and
    what one module leaves resident adds to every later test of that worker
    (`tests/test_train.py::test_train_step_sharded_avss_amp` alone peaks at
    30.2 GB resident). The other test_torch_*.py files import this
    fixture."""
    yield
    gc.collect()
    jax.clear_caches()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to trim
        pass


def _port_kwargs(jax_model):
    return {f: getattr(jax_model, f) for f in PORT_FIELDS}


def _batch(seed=0, b=B, t=T, s=S):
    """uint8 frames and Maskige, fp32 log-mel, as the loader ships them."""
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randint(0, 256, (b, t, s, s, 3)).astype(np.uint8),
        "audio_log_mel": rng.randn(b, t, 96, 64).astype(np.float32),
        "pre_masks": rng.randint(0, 256, (b, t, s, s, 3)).astype(np.uint8),
    }


@pytest.fixture(scope="module")
def tiny():
    """The tiny flagship: JAX model, port model, and the JAX variables made
    from the port's seeded weights."""
    jm = graft._flagship_model(tiny=True)
    port = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = convert_combo_checkpoint(sd, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    return jm, port, variables


def test_state_dict_from_flax_inverts_converter(tiny):
    jm, port, variables = tiny
    b = _batch()
    # the converted tree is exactly the JAX model's variable tree
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), b["images"].astype(np.float32),
                                          b["audio_log_mel"], b["pre_masks"].astype(np.float32)))
    assert jax.tree.structure(init) == jax.tree.structure(variables)
    for a, v in zip(jax.tree.leaves(init), jax.tree.leaves(variables)):
        assert a.shape == np.shape(v)

    sd = state_dict_from_flax(variables, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    assert set(sd) == set(port.state_dict())
    back = convert_combo_checkpoint(sd, dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for (path, a), v in zip(jax.tree_util.tree_flatten_with_path(variables)[0], jax.tree.leaves(back)):
        assert np.asarray(a).dtype == np.asarray(v).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(v), err_msg=str(path))

    fresh = MaskFormer(**_port_kwargs(jm), device="cpu")
    fresh.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def _x64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.mark.parametrize("mode", ["fp64", "fp64_zero_flag", "fp32", "bf16"])
def test_tiny_slice_matches_jax(tiny, mode):
    """fp64: the same function to rounding; the semantic maps are float32 on
    both sides, so 1e-6. fp64_zero_flag: the raw outputs in fp64 with the
    audio gate closed on the last frame (`vid_temporal_mask` 0 there), 1e-6.
    fp32: another summation order through two ResNet towers, the encoder and
    the decoder: atol 5e-3, rtol 1e-3 (as tests/test_e2e_parity.py). bf16:
    the port's bf16 step against the JAX bf16 step; the two frameworks round
    at other places, so the bf16 eval tolerance of tests/test_bf16_eval.py
    (0.05) applies."""
    jm, port, variables = tiny
    batch = _batch(1)
    size = (S, S)
    got = want = raw = None
    if mode.startswith("fp64"):
        net = MaskFormer(**_port_kwargs(jm), device="cpu")
        net.load_state_dict(port.state_dict())
        net = net.double().eval()
        inputs = [_x64(batch[k]) for k in ("images", "audio_log_mel", "pre_masks")]
        if mode == "fp64_zero_flag":
            flag = np.ones((B, T), np.float64)
            flag[:, -1] = 0.0
            inputs.append(flag)
        with jax.enable_x64(True):
            v64 = _x64(variables)
            if mode == "fp64":
                want = np.asarray(jax_make_eval_step(jm, size)(v64["params"], v64["frozen"],
                                                               batch))
            raw = jax.tree.map(np.asarray, jax.jit(jm.apply)(v64, *inputs))
        if mode == "fp64":
            got = make_eval_step(net, size)(batch)
        inputs = [torch.from_numpy(a) for a in inputs]
        tol = dict(atol=1e-6, rtol=1e-6)
    else:
        net = port
        bf16 = mode == "bf16"
        want = np.asarray(jax_make_eval_step(jm, size, bf16=bf16)(
            variables["params"], variables["frozen"], batch))
        got = make_eval_step(net, size, bf16=bf16)(batch)
        tol = dict(atol=5e-2, rtol=0) if mode == "bf16" else dict(atol=5e-3, rtol=1e-3)
        if mode == "fp32":
            f32 = [batch[k].astype(np.float32) for k in ("images", "audio_log_mel", "pre_masks")]
            raw = jax.tree.map(np.asarray, jax.jit(jm.apply)(variables, *f32))
            inputs = [torch.from_numpy(a) for a in f32]

    if got is not None:
        assert got.dtype == torch.float32 and tuple(got.shape) == (B * T, 2, S, S)
        assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0
        np.testing.assert_allclose(got.numpy(), want, **tol)
    if raw is not None:
        with torch.no_grad():
            out = net(*inputs)
        assert out["pred_logits"].shape == (B * T, jm.num_queries, 3)
        assert out["pred_masks"].shape == (B * T, jm.num_queries, S // 4, S // 4)
        for k in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(out[k].numpy(), raw[k], **tol)
        # dec_layers = cfg DEC_LAYERS - 1: one aux prediction per layer
        assert len(out["aux_outputs"]) == len(raw["aux_outputs"]) == jm.dec_layers


@pytest.mark.parametrize("bf16", [False, True])
def test_eval_step_follows_weight_reload(tiny, bf16):
    """A step made before `load_state_dict` runs the new weights after it, in
    both modes: bit-equal to a step made after the reload."""
    jm, port, _ = tiny
    net = MaskFormer(**_port_kwargs(jm), device="cpu")
    net.load_state_dict(port.state_dict())
    step = make_eval_step(net, (S, S), bf16=bf16)
    batch = _batch(3)
    before = step(batch)
    other = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=1)
    net.load_state_dict(other.state_dict())
    after = step(batch)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, make_eval_step(net, (S, S), bf16=bf16)(batch), rtol=0, atol=0)


def test_full_width_r50_fp64():
    """Full-width COMBO-R50 (2 encoder and 2 decoder layers, 5 queries) at
    64^2 in float64: both sides compute the same function to rounding (1e-6
    of max |output|)."""
    def build():
        return init_weights(MaskFormer(dec_layers=2, enc_layers=2, num_queries=5, device="cpu"),
                            seed=1).eval()

    # 145 M weights, 1.2 GB in float64: the JAX side runs while the port holds
    # none, and the port is built again from its seed afterwards
    sd = {k: v.numpy() for k, v in build().state_dict().items()}
    variables = _x64(convert_combo_checkpoint(sd, dec_layers=2, enc_layers=2))
    del sd
    b = _batch(2, t=1)
    inputs = [b[k].astype(np.float64) for k in ("images", "audio_log_mel", "pre_masks")]
    with jax.enable_x64(True):
        jm = JaxMaskFormer(dec_layers=2, enc_layers=2, num_queries=5)
        want = jax.tree.map(np.asarray, jax.jit(jm.apply)(variables, *inputs))
    del variables
    jax.clear_caches()
    gc.collect()
    with torch.no_grad():
        got = build().double()(*(torch.from_numpy(a) for a in inputs))
    for k in ("pred_logits", "pred_masks"):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6 * scale)


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import combo_avs_torch\n"
        "for m in pkgutil.walk_packages(combo_avs_torch.__path__, 'combo_avs_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'flax', 'yaml', 'cv2', 'combo_avs_tpu') if m in sys.modules]\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    """Without a CUDA device (and, alone, without the rest of the repo)
    chip_smoke.py exits non-zero and prints no result line."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    cwd = str(tmp_path) if alone else REPO
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout

