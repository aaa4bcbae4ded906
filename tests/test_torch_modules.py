"""Module parity of the PyTorch port against the JAX package, on the CPU.

Each port module gets a seeded init plus seeded noise on every parameter and
frozen buffer (so no weight is a trivial 0 or 1); its state dict goes through
the JAX package's own checkpoint converters into the JAX module, and both run
the same numpy inputs in float64. At float64 both sides compute the same
function to rounding, so the tolerance is 1e-9 of the output's scale: any
convention that differs (a LayerNorm epsilon of 1e-5 instead of flax's 1e-6, a
flatten order, a resize mode, a mask polarity) is orders of magnitude above it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from combo_avs_tpu.models import fusion as jfusion
from combo_avs_tpu.models import meta_arch as jmeta
from combo_avs_tpu.models import pixel_decoder as jpd
from combo_avs_tpu.models import position_encoding as jpe
from combo_avs_tpu.models import resnet as jresnet
from combo_avs_tpu.models import transformer_decoder as jtd
from combo_avs_tpu.models import vggish as jvggish
from combo_avs_tpu.train import checkpoint as jckpt
from combo_avs_torch.models import fusion, meta_arch, pixel_decoder, position_encoding, resnet
from combo_avs_torch.models import transformer_decoder, vggish
from combo_avs_torch.models.layers import init_weights
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401 (autouse fixtures)

TOL = 1e-9  # float64 on both sides; relative to max |output|


def _ported(module, seed):
    """Seeded init + seeded noise on every tensor of the state dict, in float64."""
    init_weights(module, seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
            else:
                t.add_(torch.from_numpy(0.05 * rng.randn(*t.shape)))
    return module.double().eval()


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _jax_apply(module, variables, *args):
    with jax.enable_x64(True):
        out = jax.jit(module.apply)(variables, *args)
        return jax.tree.map(np.asarray, out)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("depth,kw", [
    (10, dict(stem_out_channels=8, res2_out_channels=32)),
    (50, {}),
])
def test_resnet(depth, kw):
    port = _ported(resnet.ResNet(depth=depth, **kw), seed=depth)
    params, frozen = jckpt.convert_d2_resnet(_sd(port))
    x = np.random.RandomState(0).randn(2, 32, 32, 3)
    want = _jax_apply(jresnet.ResNet(depth=depth, **kw), {"params": params, "frozen": frozen}, x)
    with torch.no_grad():
        got = port(_nchw(x))
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    for k in want:
        _close(_nhwc(got[k]), want[k])


def test_vggish_flatten_order():
    port = _ported(vggish.VGGish(width_mult=0.125), seed=1)
    params = jckpt.convert_vggish(_sd(port))
    mel = np.random.RandomState(1).randn(3, 96, 64)
    want = _jax_apply(jvggish.VGGish(width_mult=0.125), {"params": params}, mel[..., None])
    with torch.no_grad():
        got = port(torch.from_numpy(mel[:, None]))
    assert got.shape == (3, 128)
    _close(got.numpy(), want)


def test_pixel_decoder():
    chans = {"res2": 32, "res3": 64, "res4": 128, "res5": 256}
    port = _ported(pixel_decoder.MSDeformAttnPixelDecoder(
        chans, conv_dim=32, mask_dim=32, enc_layers=1, n_heads=2), seed=2)
    params = jckpt.convert_pixel_decoder(_sd(port), prefix="", enc_layers=1)
    rng = np.random.RandomState(2)
    feats = {k: rng.randn(2, 64 // s, 64 // s, c) for (k, c), s in zip(chans.items(), (4, 8, 16, 32))}
    jmod = jpd.MSDeformAttnPixelDecoder(conv_dim=32, mask_dim=32, enc_layers=1, n_heads=2)
    want_mask, want_res5, want_ms = _jax_apply(jmod, {"params": params}, feats)
    with torch.no_grad():
        mask, res5, ms = port({k: _nchw(v) for k, v in feats.items()})
    _close(_nhwc(mask), want_mask)
    _close(_nhwc(res5), want_res5)
    for g, w in zip(ms, want_ms):  # levels res5, res4, res3: (2,2), (4,4), (8,8)
        _close(_nhwc(g), w)


def test_fusion_mha_b_and_audio_mlp():
    fuse = _ported(fusion.AVFuse(128, ("res2",), (32,)), seed=3)
    mlp = _ported(fusion.AudioMLP(32), seed=4)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 16, 32)
    audio = rng.randn(2, 1, 128)
    jfuse = jfusion.AVFuse(fused_type="MHA-B", audio_dim=128, fused_backbone=("res2",),
                           fused_backbone_dim=(32,))
    want = _jax_apply(jfuse, {"params": jckpt.convert_fusion(_sd(fuse), prefix="")},
                      {"res2": x}, audio)
    want_a = _jax_apply(jfusion.AudioMLP(32), {"params": jckpt.convert_audio_mlp(_sd(mlp), prefix="")},
                        want["audio"])
    with torch.no_grad():
        got_v, got_a = fuse({"res2": _nchw(x)}, torch.from_numpy(audio))
        got_mlp = mlp(got_a)
    _close(_nhwc(got_v["res2"]), want["visual"]["res2"])
    _close(got_a.numpy(), want["audio"])
    _close(got_mlp.numpy(), want_a)


def test_masked_transformer_decoder():
    Q, C, dec = 5, 32, 2
    port = _ported(transformer_decoder.MultiScaleMaskedTransformerDecoder(
        2, hidden_dim=C, num_queries=Q, nheads=2, dim_feedforward=64, dec_layers=dec, mask_dim=C),
        seed=5)
    params = jckpt.convert_predictor(_sd(port), prefix="", dec_layers=dec)
    rng = np.random.RandomState(5)
    xs = [rng.randn(2, s, s, C) for s in (2, 4, 8)]
    audio = rng.randn(2, 1, C)
    mask_features = rng.randn(2, 16, 16, C)
    jmod = jtd.MultiScaleMaskedTransformerDecoder(
        num_classes=2, hidden_dim=C, num_queries=Q, nheads=2, dim_feedforward=64,
        dec_layers=dec, mask_dim=C, audio_out_dim=C)
    want = _jax_apply(jmod, {"params": params}, xs, audio, mask_features)
    with torch.no_grad():
        got = port([_nchw(x) for x in xs], torch.from_numpy(audio), _nchw(mask_features))
    _close(got["pred_logits"].numpy(), want["pred_logits"])
    _close(got["pred_masks"].numpy(), want["pred_masks"])
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == dec
    for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
        _close(g["pred_masks"].numpy(), w["pred_masks"])


@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-6),  # fp32 resize + softmax x sigmoid: rounding only
    # bf16 masks against the fp32 reference: bf16 rounds the resized masks and
    # their sigmoid (2^-8 relative); the probabilities stay within 1e-2
    (torch.bfloat16, 1e-2),
])
def test_semantic_inference_out_size(dtype, atol):
    rng = np.random.RandomState(6)
    cls = rng.randn(3, 5, 3).astype(np.float32)
    masks = (3 * rng.randn(3, 5, 14, 14)).astype(np.float32)
    want = np.asarray(jmeta.semantic_inference(jnp.asarray(cls), jnp.asarray(masks), out_size=(56, 56)))
    got = meta_arch.semantic_inference(torch.from_numpy(cls), torch.from_numpy(masks).to(dtype),
                                       out_size=(56, 56))
    assert got.dtype == torch.float32 and got.shape == (3, 2, 56, 56)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("src,dst", [(56, 7), (56, 14), (56, 28), (7, 28), (14, 56), (16, 64)])
def test_bilinear_resize_matches_jax_at_edges(src, dst):
    """F.interpolate(bilinear, align_corners=False, antialias=False) against
    jax.image.resize(bilinear, antialias=False): the decoder's mask
    downsampling, the FPN upsample and the semantic-map upsample."""
    x = np.random.RandomState(src + dst).randn(2, 3, src, src)
    want = np.asarray(jax.image.resize(x.astype(np.float32), (2, 3, dst, dst), "bilinear",
                                       antialias=False))
    got = F.interpolate(torch.from_numpy(x).float(), size=(dst, dst), mode="bilinear",
                        align_corners=False, antialias=False).numpy()
    for edge in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0], np.s_[..., :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("h,w", [(7, 7), (14, 28), (56, 56)])
def test_numpy_constants_bit_identical(h, w):
    np.testing.assert_array_equal(position_encoding.sine_position_encoding(h, w, 128),
                                  jpe.sine_position_encoding(h, w, 128))
    shapes = ((h, w), (2 * h, 2 * w))
    np.testing.assert_array_equal(pixel_decoder.encoder_reference_points(shapes),
                                  jpd.encoder_reference_points(shapes))
    want = jpd._directional_offset_bias(8, 3, 4)(None, (8 * 3 * 4 * 2,), jnp.float32)
    got = torch.from_numpy(pixel_decoder.directional_offset_bias(8, 3, 4)).float()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
