"""Checkpoints: reference `.pth` / `.pkl` files into the port's model,
pretrained backbone and VGGish files into its towers, the training state to
disk and back, and JAX-package variables into the port's state dict.

`load_reference_checkpoint` reads a reference checkpoint (`model_best.pth`,
or a d2-style `.pkl`) as `combo_avs_tpu/train/checkpoint.py::load_torch_file`
reads it, and loads it into a `MaskFormer` by the reference key names, which
the port's modules carry. A file that holds the visual tower but not the
pre-SAM one fills both from it (`fan_out_siamese`). The criterion's keys
are dropped; the rest are checked strictly: a missing or an unexpected key
raises.

`convert_caffe2_resnet` (an MSRA `R-50.pkl`, BN folded into `_bn_s` /
`_bn_b`), `convert_d2_resnet` (d2 names), `convert_resnet` (either, by its
keys) and `convert_vggish` (the torchvggish `.pth`) are ports of the JAX
package's importers (`combo_avs_tpu/train/checkpoint.py:86-169`) into the
port's key names: one tower's keys (`stem.conv1.weight`,
`res2.0.conv1.norm.running_var`, ...) or the VGGish module's. `load_pretrained`
puts them into a `MaskFormer`, one backbone file filling both towers.

`save_checkpoint` / `load_checkpoint` keep the whole training state
(weights, AdamW moments, the optimizer's step count, the generator state,
the iteration) in `step_N/state.pth` directories, the newest `keep` of
them (`combo_avs_tpu/train/checkpoint.py:390-420`); `BestCheckpointer`
(:422-456) keeps the weights of the best evaluation as `model_best.pth` in
the reference layout, which `load_reference_checkpoint` reads.

`convert_pvt` reads a timm-named PVTv2 file (`d2_pvt_v2_b5.pkl`) into one
PVT tower's keys, which are timm's; `load_pretrained` fills both towers of a
PVT model from it.

`state_dict_from_flax` is the inverse of
`combo_avs_tpu/train/checkpoint.py::convert_combo_checkpoint` for the ResNet
and the PVT model, and reads every variant the port builds: it takes the
flax variable tree ({"params": ...}, and "frozen" for the ResNet's FrozenBN
statistics; numpy leaves) and returns the reference `.pth` key names the
port's modules use (the FPN decoders' `adapter_{k}` / `layer_{k}` numbered
from res2 = 1, as the reference's fpn.py; the MHA-S block's under
`a2i_attn.`, a pattern of the port's, since no published MHA-S file is read). Layouts: conv HWIO ->
OIHW, Dense [in, out] -> Linear [out, in], LayerNorm / GroupNorm `scale` ->
`weight`, and scanned parameters (the pixel decoder's encoder layers, each
PVT stage's blocks, stacked on a leading axis) unstacked into one key per
layer or block.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from combo_avs_torch.models.pvtv2 import PVTv2

logger = logging.getLogger("COMBO")

# conv positions in the torchvggish Sequential, and linear positions in the
# [Linear, ReLU] x 3 embeddings / AudioMLP Sequentials
_VGG_CONV_IDS = (0, 3, 6, 8, 11, 13)
_FC_IDS = (0, 2, 4)
_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# the reference MaskFormer's submodules that only training uses
TRAINING_ONLY = ("criterion.",)


def _conv(k):  # HWIO -> OIHW
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _lin(k):  # [in, out] -> [out, in]
    return np.ascontiguousarray(np.asarray(k).T)


def _resnet(sd: dict, prefix: str, params: dict, frozen: dict) -> None:
    sd[f"{prefix}stem.conv1.weight"] = _conv(params["stem_conv1"]["kernel"])
    for leaf, v in frozen["stem_norm1"].items():
        sd[f"{prefix}stem.conv1.norm.{_NORM_LEAF[leaf]}"] = np.asarray(v)
    for name, block in params.items():
        if name == "stem_conv1":
            continue
        stage, b = name.split("_block")  # "res2_block0" -> ("res2", "0")
        for conv, p in block.items():
            sd[f"{prefix}{stage}.{b}.{conv}.weight"] = _conv(p["kernel"])
        for norm, leaves in frozen[name].items():
            conv = "shortcut" if norm == "shortcut_norm" else f"conv{norm[-1]}"
            for leaf, v in leaves.items():
                sd[f"{prefix}{stage}.{b}.{conv}.norm.{_NORM_LEAF[leaf]}"] = np.asarray(v)


def _pvt(sd: dict, prefix: str, params: dict) -> None:
    """A JAX PVTv2 tower (each stage's blocks stacked on a leading depth
    axis, `combo_avs_tpu/train/checkpoint.py::convert_pvt`) -> timm keys."""
    i = 1
    while f"patch_embed{i}" in params:
        sd[f"{prefix}patch_embed{i}.proj.weight"] = _conv(params[f"patch_embed{i}"]["kernel"])
        sd[f"{prefix}patch_embed{i}.proj.bias"] = np.asarray(params[f"patch_embed{i}"]["bias"])
        _norm(sd, f"{prefix}patch_embed{i}.norm", params[f"patch_norm{i}"])
        _norm(sd, f"{prefix}norm{i}", params[f"norm{i}"])
        stage = params[f"block{i}"]
        for j in range(len(stage["norm1"]["scale"])):
            one = _index(stage, j)
            key = f"{prefix}block{i}.{j}."
            for ln in ("norm1", "norm2"):
                _norm(sd, f"{key}{ln}", one[ln])
            for lin in ("q", "kv", "proj"):
                _dense(sd, f"{key}attn.{lin}", one["attn"][lin])
            if "sr" in one["attn"]:
                sd[f"{key}attn.sr.weight"] = _conv(one["attn"]["sr"]["kernel"])
                sd[f"{key}attn.sr.bias"] = np.asarray(one["attn"]["sr"]["bias"])
                _norm(sd, f"{key}attn.norm", one["attn"]["sr_norm"])
            for lin in ("fc1", "fc2"):
                _dense(sd, f"{key}mlp.{lin}", one["mlp"][lin])
            # depthwise HWIO (3, 3, 1, C) -> OIHW (C, 1, 3, 3)
            sd[f"{key}mlp.dwconv.dwconv.weight"] = _conv(one["mlp"]["dwconv"]["kernel"])
            sd[f"{key}mlp.dwconv.dwconv.bias"] = np.asarray(one["mlp"]["dwconv"]["bias"])
        i += 1


def _index(tree, j: int):
    """Entry j of every leaf's leading axis."""
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _lin(p["kernel"])
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _norm(sd, key, p):
    sd[f"{key}.weight"] = np.asarray(p["scale"])
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _pixel_decoder(sd, prefix, p, enc_layers):
    for i in range(3):
        sd[f"{prefix}input_proj.{i}.0.weight"] = _conv(p[f"input_proj{i}"]["kernel"])
        sd[f"{prefix}input_proj.{i}.0.bias"] = np.asarray(p[f"input_proj{i}"]["bias"])
        _norm(sd, f"{prefix}input_proj.{i}.1", p[f"input_norm{i}"])
    sd[f"{prefix}transformer.level_embed"] = np.asarray(p["level_embed"])
    enc = p["encoder"]
    for layer in range(enc_layers):
        key = f"{prefix}transformer.encoder.layers.{layer}."
        for lin in ("value_proj", "output_proj", "sampling_offsets", "attention_weights"):
            q = enc["self_attn"][lin]
            _dense(sd, f"{key}self_attn.{lin}", {"kernel": q["kernel"][layer], "bias": q["bias"][layer]})
        for ln in ("norm1", "norm2"):
            q = enc[ln]
            _norm(sd, f"{key}{ln}", {"scale": q["scale"][layer], "bias": q["bias"][layer]})
        for lin in ("linear1", "linear2"):
            q = enc["ffn"][lin]
            _dense(sd, f"{key}{lin}", {"kernel": q["kernel"][layer], "bias": q["bias"][layer]})
    sd[f"{prefix}adapter_1.weight"] = _conv(p["adapter0"]["kernel"])
    _norm(sd, f"{prefix}adapter_1.norm", p["adapter_norm0"])
    sd[f"{prefix}layer_1.weight"] = _conv(p["layer0"]["kernel"])
    _norm(sd, f"{prefix}layer_1.norm", p["layer_norm0"])
    sd[f"{prefix}mask_features.weight"] = _conv(p["mask_features"]["kernel"])
    sd[f"{prefix}mask_features.bias"] = np.asarray(p["mask_features"]["bias"])


def _embeddings(sd, prefix, p):
    """fc0..fc2 -> the `embeddings.{0,2,4}` Sequential (VGGish, AudioMLP)."""
    for i, tid in enumerate(_FC_IDS):
        _dense(sd, f"{prefix}embeddings.{tid}", p[f"fc{i}"])


def _vggish(sd, prefix, p):
    for i, tid in enumerate(_VGG_CONV_IDS):
        sd[f"{prefix}features.{tid}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        sd[f"{prefix}features.{tid}.bias"] = np.asarray(p[f"conv{i}"]["bias"])
    _embeddings(sd, prefix, p)


def _levels(p, fmt: str) -> int:
    n = 0
    while fmt.format(n) in p:
        n += 1
    return n


def _fusion(sd, prefix, p):
    """An AVFuse of any type: the bilateral block (MHA-B, MHA-S-Audio), the
    audio -> image block (MHA-S) or neither (MHA-None)."""
    sd[f"{prefix}audio_pos.weight"] = np.asarray(p["audio_pos"])
    sd[f"{prefix}level_embed.weight"] = np.asarray(p["level_embed"])
    if "b_attn" in p:
        b, q = f"{prefix}b_attn.", p["b_attn"]
        for lvl in range(_levels(q, "attn{}")):
            _norm(sd, f"{b}layer_norm_v_list.{lvl}", q[f"norm_v{lvl}"])
            _norm(sd, f"{b}layer_norm_a_list.{lvl}", q[f"norm_a{lvl}"])
            for lin, v in q[f"attn{lvl}"].items():
                _dense(sd, f"{b}attn_list.{lvl}.{lin}", v)
            sd[f"{b}gamma_v_list.{lvl}"] = np.asarray(q[f"gamma_v{lvl}"])
        sd[f"{b}gamma_a"] = np.asarray(q["gamma_a"])
    if "a2i_attn" in p:
        b, q = f"{prefix}a2i_attn.", p["a2i_attn"]
        for lvl in range(_levels(q, "attn{}")):
            _norm(sd, f"{b}layer_norm_q_list.{lvl}", q[f"norm_q{lvl}"])
            _norm(sd, f"{b}layer_norm_k_list.{lvl}", q[f"norm_k{lvl}"])
            for lin, v in q[f"attn{lvl}"].items():
                _dense(sd, f"{b}attn_list.{lvl}.{lin}", v)
            sd[f"{b}gamma_list.{lvl}"] = np.asarray(q[f"gamma{lvl}"])


def _conv_bias(sd, key, p):
    sd[f"{key}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _fpn(sd, prefix, p):
    """The JAX FPN's convs, numbered from the lowest resolution (`layer0` on
    res5), -> the reference's `layer_{k}` / `adapter_{k}`, numbered from
    res2 = 1."""
    n = _levels(p, "layer{}")
    for idx in range(n):
        k = n - idx
        _conv_bias(sd, f"{prefix}layer_{k}", p[f"layer{idx}"])
        _norm(sd, f"{prefix}layer_{k}.norm", p[f"layer_norm{idx}"])
        if idx:
            _conv_bias(sd, f"{prefix}adapter_{k}", p[f"adapter{idx}"])
            _norm(sd, f"{prefix}adapter_{k}.norm", p[f"adapter_norm{idx}"])
    _conv_bias(sd, f"{prefix}mask_features", p["mask_features"])


def _mha(sd, key, q):
    sd[f"{key}.in_proj_weight"] = np.asarray(q["in_proj_weight"])
    sd[f"{key}.in_proj_bias"] = np.asarray(q["in_proj_bias"])
    _dense(sd, f"{key}.out_proj", q["out_proj"])


def _any_pixel_decoder(sd, prefix, p, enc_layers):
    """The deformable pixel decoder, or an FPN one (`fpn_decoder.py`): the
    plain FPN, or the transformer encoder on res5 (`input_proj`,
    `encoder{i}`) ahead of it."""
    if "encoder" in p:
        _pixel_decoder(sd, prefix, p, enc_layers)
        return
    if "fpn" not in p:
        _fpn(sd, prefix, p)
        return
    _conv_bias(sd, f"{prefix}input_proj", p["input_proj"])
    for i in range(_levels(p, "encoder{}")):
        q, key = p[f"encoder{i}"], f"{prefix}transformer.encoder.layers.{i}."
        _mha(sd, f"{key}self_attn", q["self_attn"])
        for name in ("linear1", "linear2"):
            _dense(sd, f"{key}{name}", q[name])
        for name in ("norm1", "norm2"):
            _norm(sd, f"{key}{name}", q[name])
    _fpn(sd, prefix, p["fpn"])


def _predictor(sd, prefix, p, dec_layers):
    for name in ("query_feat", "query_embed", "level_embed"):
        sd[f"{prefix}{name}.weight"] = np.asarray(p[name])
    for i in range(3):
        if f"input_proj{i}" in p:
            _conv_bias(sd, f"{prefix}input_proj.{i}", p[f"input_proj{i}"])
    for i in range(dec_layers):
        for kind, attn in (("self", "self_attn"), ("cross", "multihead_attn")):
            key = f"{prefix}transformer_{kind}_attention_layers.{i}."
            q = p[f"{kind}_attn{i}"]
            sd[f"{key}{attn}.in_proj_weight"] = np.asarray(q["in_proj_weight"])
            sd[f"{key}{attn}.in_proj_bias"] = np.asarray(q["in_proj_bias"])
            _dense(sd, f"{key}{attn}.out_proj", q["out_proj"])
            _norm(sd, f"{key}norm", p[f"{kind}_norm{i}"])
        key = f"{prefix}transformer_ffn_layers.{i}."
        _dense(sd, f"{key}linear1", p[f"ffn_linear1_{i}"])
        _dense(sd, f"{key}linear2", p[f"ffn_linear2_{i}"])
        _norm(sd, f"{key}norm", p[f"ffn_norm{i}"])
    _norm(sd, f"{prefix}decoder_norm", p["decoder_norm"])
    _dense(sd, f"{prefix}class_embed", p["class_embed"])
    for i in range(3):
        _dense(sd, f"{prefix}mask_embed.layers.{i}", p["mask_embed"][f"layer{i}"])


def state_dict_from_flax(variables: Dict, dec_layers: int = 9, enc_layers: int = 6) -> Dict[str, np.ndarray]:
    """The variables of the JAX MaskFormer -> {key: numpy array} for
    `combo_avs_torch.models.meta_arch.MaskFormer.load_state_dict` (after
    `torch.from_numpy`): {"params", "frozen"} of the ResNet model, or
    {"params"} of the PVT model, which has no frozen collection. Every
    variant the port builds: with or without the pre-SAM tower and its SE
    gates, early fusion (`fusion_module` and `audio_transformation` at the
    top) or late (in the head), each fusion type, each pixel decoder, the
    decoder's `input_proj{i}` and a `query_feat` of any width. `enc_layers`
    counts the deformable decoder's layers (scanned, so not countable from
    the tree); the FPN decoders' are counted."""
    params = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    for tower in ("backbone", "pre_sam_backbone"):
        if tower not in params:
            continue
        if "patch_embed1" in params[tower]:
            _pvt(sd, f"{tower}.", params[tower])
        else:
            _resnet(sd, f"{tower}.", params[tower], variables["frozen"][tower])
    _vggish(sd, "audio_backbone.", params["audio_backbone"])
    i = 0
    while f"scale_factor{i}" in params:
        for fc in ("fc1", "fc2"):
            _dense(sd, f"scale_factor_module.{i}.{fc}", params[f"scale_factor{i}"][fc])
        i += 1
    head = params["sem_seg_head"]
    for prefix, node in (("", params), ("sem_seg_head.", head)):
        if "fusion_module" in node:
            _fusion(sd, f"{prefix}fusion_module.", node["fusion_module"])
            _embeddings(sd, f"{prefix}audio_transformation.", node["audio_transformation"])
    _any_pixel_decoder(sd, "sem_seg_head.pixel_decoder.", head["pixel_decoder"], enc_layers)
    _predictor(sd, "sem_seg_head.predictor.", head["predictor"], dec_layers)
    return sd


def load_reference_file(path: str) -> Dict[str, np.ndarray]:
    """A `.pth` (torch pickle) or `.pkl` (plain or Caffe2 pickle) -> flat
    {name: numpy array}: the `model` (or `state_dict`) entry when there is
    one, without `__`-prefixed metadata and entries that are not arrays.
    Checkpoints are trusted input: unpickling runs whatever the file holds."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            obj = pickle.load(f, encoding="latin1")
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in obj.items() if not k.startswith("__") and hasattr(v, "shape")}


def fan_out_siamese(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One backbone fills both towers: without `pre_sam_backbone.*` keys, the
    pre-SAM tower takes a copy of `backbone.*` (ref README.md:49-62)."""
    if any(k.startswith("pre_sam_backbone.") for k in sd):
        return sd
    tower = {f"pre_sam_{k}": v.copy() for k, v in sd.items() if k.startswith("backbone.")}
    return {**sd, **tower}


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference checkpoint file into `model` in place, on the
    model's device and in its parameters' type. The reference model carries
    its training criterion (`criterion.empty_weight`), which inference does
    not use and `convert_combo_checkpoint` does not read: `criterion.*` keys
    are dropped. Raises ValueError naming the missing and unexpected keys
    when the rest of the file does not cover the model exactly."""
    sd = {k: v for k, v in load_reference_file(path).items() if not k.startswith(TRAINING_ONLY)}
    own = model.state_dict()
    if any(k.startswith("pre_sam_backbone.") for k in own):
        sd = fan_out_siamese(sd)
    missing, unexpected = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or unexpected:
        raise ValueError(f"{path}: {len(missing)} missing keys {missing[:8]}, "
                         f"{len(unexpected)} unexpected keys {unexpected[:8]}")
    model.load_state_dict({k: torch.from_numpy(np.array(v)).to(own[k].dtype)
                           for k, v in sd.items()}, strict=True)


def save_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Write the model as a d2-style checkpoint, {"model": state dict} of
    CPU tensors under the reference key names."""
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}}, path)


# ---------------------------------------------------------------------------
# pretrained towers
# ---------------------------------------------------------------------------

_CAFFE2_BRANCH = {"branch1": "shortcut", "branch2a": "conv1", "branch2b": "conv2",
                  "branch2c": "conv3"}
_D2_NORM = ("weight", "bias", "running_mean", "running_var")


def _folded_bn(key: str, scale: np.ndarray, bias: np.ndarray) -> Dict[str, np.ndarray]:
    """A Caffe2 BN with its statistics folded into scale and bias: mean 0 and
    a variance that makes sqrt(var + 1e-5) one."""
    return {f"{key}.weight": scale, f"{key}.bias": bias,
            f"{key}.running_mean": np.zeros_like(scale),
            f"{key}.running_var": np.ones_like(scale) - 1e-5}


def convert_caffe2_resnet(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An MSRA / Caffe2 ResNet (`conv1_w`, `res2_0_branch2a_w`, ...,
    `res2_0_branch2a_bn_s`) -> one tower's keys. Other keys (`fc1000_*`) are
    not read."""
    out = {"stem.conv1.weight": sd["conv1_w"],
           **_folded_bn("stem.conv1.norm", sd["res_conv1_bn_s"], sd["res_conv1_bn_b"])}
    for key in sd:
        m = re.match(r"res(\d)_(\d+)_(branch\w+)_w$", key)
        if not m:
            continue
        stage, block, branch = m.groups()
        base = f"res{stage}.{block}.{_CAFFE2_BRANCH[branch]}"
        out[f"{base}.weight"] = sd[key]
        stem = key[:-len("_w")]
        out.update(_folded_bn(f"{base}.norm", sd[f"{stem}_bn_s"], sd[f"{stem}_bn_b"]))
    return out


def convert_d2_resnet(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    """d2 names (`stem.conv1.weight`, `res2.0.conv1.norm.running_mean`, ...)
    under `prefix` -> one tower's keys: conv weights and the four norm
    tensors (`num_batches_tracked` and the like are not read)."""
    out = {}
    for key, v in sd.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        m = re.match(r"(stem\.conv1|res\d\.\d+\.(?:conv\d|shortcut))\.(.*)$", k)
        if m and (m.group(2) == "weight"
                  or (m.group(2).startswith("norm.") and m.group(2)[5:] in _D2_NORM)):
            out[k] = v
    return out


def convert_resnet(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    if any(k.startswith("conv1_w") for k in sd):
        return convert_caffe2_resnet(sd)
    return convert_d2_resnet(sd, prefix)


def convert_vggish(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    """The torchvggish state dict (`features.N`, `embeddings.N`) -> the keys
    of the port's VGGish module."""
    out = {}
    for tid in _VGG_CONV_IDS:
        for leaf in ("weight", "bias"):
            out[f"features.{tid}.{leaf}"] = sd[f"{prefix}features.{tid}.{leaf}"]
    for tid in _FC_IDS:
        for leaf in ("weight", "bias"):
            out[f"embeddings.{tid}.{leaf}"] = sd[f"{prefix}embeddings.{tid}.{leaf}"]
    return out


# the keys of one PVTv2 tower (timm's names)
_PVT_KEY = re.compile(r"(patch_embed\d\.(proj|norm)|norm\d|block\d\.\d+\.(norm1|norm2"
                      r"|attn\.(q|kv|proj|sr|norm)|mlp\.(fc1|fc2|dwconv\.dwconv)))\.(weight|bias)$")


def convert_pvt(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    """A timm-named PVTv2 file (`d2_pvt_v2_b5.pkl`, or a trained model's
    towers under `prefix`) -> one tower's keys, which are timm's. Keys a
    tower does not have (the classifier `head.*`, ...) are not read, as
    `combo_avs_tpu/train/checkpoint.py::convert_pvt` reads tower keys only."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and _PVT_KEY.match(k[len(prefix):])}


def _load_part(model: torch.nn.Module, part: Dict[str, np.ndarray], what: str) -> None:
    """Copy `part` (full key names) into `model`; it must cover the submodules
    it names exactly, in their shapes."""
    own = model.state_dict()
    prefixes = {k.split(".", 1)[0] + "." for k in part}
    want = {k for k in own if k.startswith(tuple(prefixes))}
    missing, unexpected = sorted(want - set(part)), sorted(set(part) - want)
    if missing or unexpected:
        raise ValueError(f"{what}: {len(missing)} missing keys {missing[:8]}, "
                         f"{len(unexpected)} unexpected keys {unexpected[:8]}")
    with torch.no_grad():
        for k, v in part.items():
            if tuple(own[k].shape) != tuple(np.shape(v)):
                raise ValueError(f"{what}: {k} is {tuple(np.shape(v))}, the model's "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(torch.from_numpy(np.array(v)))


def load_pretrained(model: torch.nn.Module, weights: str = "", vggish: str = "") -> None:
    """MODEL.WEIGHTS (an R-50 `.pkl` or d2 file for ResNet towers, a timm
    PVTv2 file for PVT ones, by the model's backbone) into both towers and
    the VGGish `.pth` into the (frozen) audio tower, each when its file
    exists; a file that is named but missing is logged and skipped, and that
    tower keeps its initialization, as the JAX package's
    `train_net.py::load_pretrained` does."""
    if weights and os.path.exists(weights):
        sd = load_reference_file(weights)
        tower = convert_pvt(sd) if isinstance(model.backbone, PVTv2) else convert_resnet(sd)
        part = {f"backbone.{k}": v for k, v in tower.items()}
        if hasattr(model, "pre_sam_backbone"):
            part = fan_out_siamese(part)
        _load_part(model, part, weights)
        logger.info("Loaded backbone weights from %s", weights)
    elif weights:
        logger.info("MODEL.WEIGHTS %s not found: the backbone keeps its initialization",
                    weights)
    if vggish and os.path.exists(vggish):
        part = convert_vggish(load_reference_file(vggish))
        _load_part(model, {f"audio_backbone.{k}": v for k, v in part.items()}, vggish)
        logger.info("Loaded VGGish weights from %s", vggish)
    elif vggish:
        logger.info("VGGish weights %s not found: the audio tower keeps its initialization",
                    vggish)


# ---------------------------------------------------------------------------
# the training state
# ---------------------------------------------------------------------------

STATE_FILE = "state.pth"


def step_dirs(ckpt_dir: str) -> Dict[int, str]:
    """{step: path} of the `step_N` checkpoints under `ckpt_dir`."""
    if not os.path.isdir(ckpt_dir):
        return {}
    out = {}
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE)):
            out[int(m.group(1))] = os.path.join(ckpt_dir, name)
    return out


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, optimizer, generator: torch.Generator,
                    step: int, keep: int = 5) -> str:
    """The training state after `step` iterations under `step_{step}/`; then
    only the newest `keep` step checkpoints stay (d2's PeriodicCheckpointer
    max_to_keep). `optimizer` is `train/optim.py::Optimizer`."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "optimizer": optimizer.inner.state_dict(), "count": optimizer.count,
             "generator": generator.get_state(), "iter": step}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if keep and keep > 0:
        for s in sorted(step_dirs(ckpt_dir))[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    return path


def load_checkpoint(path: str, model: torch.nn.Module, optimizer,
                    generator: Optional[torch.Generator] = None) -> int:
    """Restore what `save_checkpoint` wrote into `model`, `optimizer` and
    `generator` (each on its own device); returns the iteration."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=False)
    model.load_state_dict(state["model"], strict=True)
    optimizer.inner.load_state_dict(state["optimizer"])
    optimizer.count = int(state["count"])
    if generator is not None:
        generator.set_state(state["generator"])
    return int(state["iter"])


class BestCheckpointer:
    """Keep the weights of the best evaluation by `metric` as
    `model_best.pth` (ref: models/engine/hooks.py:14-101)."""

    def __init__(self, ckpt_dir: str, metric: str = "mIoU", mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode {mode!r}: max or min")
        self.ckpt_dir, self.metric, self.mode = ckpt_dir, metric, mode
        self.best: Optional[float] = None
        self.best_path: Optional[str] = None

    def update(self, results: Dict[str, Dict[str, float]], model: torch.nn.Module,
               step: int) -> bool:
        value = results["sem_seg"][self.metric]
        better = (self.best is None or (self.mode == "max" and value > self.best)
                  or (self.mode == "min" and value < self.best))
        if better:
            self.best = value
            self.best_path = os.path.join(self.ckpt_dir, "model_best.pth")
            save_reference_checkpoint(model, self.best_path)
            logger.info("model_best.pth: %s %.4f at iteration %d", self.metric, value, step)
        return better
