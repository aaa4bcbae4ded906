"""JAX-package variables -> the port's state dict (numpy only).

`state_dict_from_flax` is the inverse of
`combo_avs_tpu/train/checkpoint.py::convert_combo_checkpoint` for the ResNet
model: it takes the flax variable tree ({"params": ..., "frozen": ...}, numpy
leaves) and returns the reference `.pth` key names the port's modules use.
Layouts: conv HWIO -> OIHW, Dense [in, out] -> Linear [out, in], LayerNorm /
GroupNorm `scale` -> `weight`, and the pixel decoder's scanned encoder
parameters (stacked on a leading layer axis) unstacked into one key per layer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# conv positions in the torchvggish Sequential, and linear positions in the
# [Linear, ReLU] x 3 embeddings / AudioMLP Sequentials
_VGG_CONV_IDS = (0, 3, 6, 8, 11, 13)
_FC_IDS = (0, 2, 4)
_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


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


def _fusion(sd, prefix, p):
    sd[f"{prefix}audio_pos.weight"] = np.asarray(p["audio_pos"])
    sd[f"{prefix}level_embed.weight"] = np.asarray(p["level_embed"])
    b, q = f"{prefix}b_attn.", p["b_attn"]
    _norm(sd, f"{b}layer_norm_v_list.0", q["norm_v0"])
    _norm(sd, f"{b}layer_norm_a_list.0", q["norm_a0"])
    for lin, v in q["attn0"].items():
        _dense(sd, f"{b}attn_list.0.{lin}", v)
    sd[f"{b}gamma_v_list.0"] = np.asarray(q["gamma_v0"])
    sd[f"{b}gamma_a"] = np.asarray(q["gamma_a"])


def _predictor(sd, prefix, p, dec_layers):
    for name in ("query_feat", "query_embed", "level_embed"):
        sd[f"{prefix}{name}.weight"] = np.asarray(p[name])
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
    """{"params", "frozen"} of the JAX ResNet MaskFormer -> {key: numpy array}
    for `combo_avs_torch.models.meta_arch.MaskFormer.load_state_dict`
    (after `torch.from_numpy`)."""
    params, frozen = variables["params"], variables["frozen"]
    sd: Dict[str, np.ndarray] = {}
    for tower in ("backbone", "pre_sam_backbone"):
        _resnet(sd, f"{tower}.", params[tower], frozen[tower])
    _vggish(sd, "audio_backbone.", params["audio_backbone"])
    i = 0
    while f"scale_factor{i}" in params:
        for fc in ("fc1", "fc2"):
            _dense(sd, f"scale_factor_module.{i}.{fc}", params[f"scale_factor{i}"][fc])
        i += 1
    head = params["sem_seg_head"]
    _pixel_decoder(sd, "sem_seg_head.pixel_decoder.", head["pixel_decoder"], enc_layers)
    _fusion(sd, "sem_seg_head.fusion_module.", head["fusion_module"])
    _embeddings(sd, "sem_seg_head.audio_transformation.", head["audio_transformation"])
    _predictor(sd, "sem_seg_head.predictor.", head["predictor"], dec_layers)
    return sd
