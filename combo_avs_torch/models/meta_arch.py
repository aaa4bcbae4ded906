"""MaskFormer meta-architecture (COMBO-R50, COMBO-PVTv2-B5 and their
component variants).

Port of `combo_avs_tpu/models/meta_arch.py`: pixel mean/std normalization,
the VGGish audio embedding (frozen unless `freeze_audio` is off), the visual
ResNet-50 or PVTv2-B5 tower and, with `use_pre_sam`, the Siam-Encoder tower
over the Maskige joined to it by per-stage SE gates; early fusion (`AVFuse`
on the backbone maps, then the audio MLP) or late fusion (in the head); and
the MaskFormer head. Keeps the JAX package's layouts at
the public surface: `forward(images [B, T, H, W, 3], audio_log_mel [B, T, 96, 64], pre_masks
[B, T, H, W, 3] or None without the SEM tower, vid_temporal_mask [B, T])` ->
`pred_logits [B*T, Q, C+1]`,
`pred_masks [B*T, Q, H/4, W/4]` and the per-layer `aux_outputs`. Internally
everything is NCHW. A `vid_temporal_mask` gates each frame's audio feature, as
the JAX model does: a frame whose flag is 0 gets a zero audio feature.

`state_dict()` keys are the reference `.pth` names that
`combo_avs_tpu/train/checkpoint.py::convert_combo_checkpoint` reads.

The model is built on the current CUDA device unless the caller passes
another `device` (the CPU tests pass "cpu"). A frozen VGGish tower runs
under `torch.no_grad()` (the JAX package's stop_gradient). In training
mode the fusion's attention dropout and the PVT towers' drop path draw from
the `dropout_generator` that `forward` is given.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from combo_avs_torch.models.fusion import AUDIO_FEATURE_DIM, FUSION_TYPES, AudioMLP, AVFuse
from combo_avs_torch.models.head import PIXEL_DECODERS, MaskFormerHead
from combo_avs_torch.models.layers import SqueezeExcite
from combo_avs_torch.models.pvtv2 import B5_DEPTHS, DROP_PATH_RATE, EMBED_DIMS, PVTv2
from combo_avs_torch.models.resnet import ResNet
from combo_avs_torch.models.transformer_decoder import QUERIES_FUSE_TYPES
from combo_avs_torch.models.vggish import VGGish
from combo_avs_torch.ops import seminf_cuda
from combo_avs_torch.ops.seminf_cuda import _upcast32

PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
STAGES = ("res2", "res3", "res4", "res5")
# each backbone's widths of res2..res5
BACKBONE_CHANNELS = {"build_resnet_backbone": (256, 512, 1024, 2048),
                     "build_pvtv2_b5_backbone": EMBED_DIMS,
                     "tiny_resnet": (32, 64, 128, 256)}


def default_device(device: Optional[torch.device | str] = None) -> torch.device:
    """`device`, or the current CUDA device when it is None; raises when there
    is no CUDA device, since the port's entry points run on the card unless
    the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _build_backbone(name: str, pvt_depths: Sequence[int]) -> nn.Module:
    if name == "build_resnet_backbone":
        return ResNet(depth=50)
    if name == "build_pvtv2_b5_backbone":
        return PVTv2(depths=pvt_depths)
    if name == "tiny_resnet":
        # one bottleneck per stage, 8x narrower: the tiny test backbone
        return ResNet(depth=10, stem_out_channels=8, res2_out_channels=32)
    raise ValueError(f"backbone {name!r} is not ported yet")


class MaskFormer(nn.Module):
    def __init__(
        self,
        backbone_name: str = "build_resnet_backbone",
        num_classes: int = 2,
        num_queries: int = 100,
        hidden_dim: int = 256,
        nheads: int = 8,
        dim_feedforward: int = 2048,
        dec_layers: int = 9,  # = cfg DEC_LAYERS - 1
        enc_layers: int = 6,
        mask_dim: int = 256,
        conv_dim: int = 256,
        audio_dim: int = 128,
        audio_out_dim: int = 256,
        pre_sam_dim: Sequence[int] = (256, 512, 1024, 2048),
        vggish_width: float = 1.0,
        # the PVT towers' depths; the JAX model's test knob (B5 unless a test cuts it)
        pvt_depths: Sequence[int] = B5_DEPTHS,
        use_pre_sam: bool = True,
        freeze_audio: bool = True,
        fusion_step: str = "late",
        fused_type: str = "MHA-B",
        fused_backbone: Sequence[str] = ("res2",),
        fused_backbone_dim: Sequence[int] = (256,),
        queries_fuse_type: str = "add",
        enforce_input_project: bool = False,
        use_cosine_loss: bool = True,
        pixel_decoder_name: str = "MSDeformAttnPixelDecoder",
        device: Optional[torch.device | str] = None,
    ):
        super().__init__()
        if fusion_step not in ("early", "late"):
            raise ValueError(f"fusion_step {fusion_step!r}: early or late")
        self.use_pre_sam, self.freeze_audio = use_pre_sam, freeze_audio
        self.early = fusion_step == "early"
        with default_device(device):
            self.backbone = _build_backbone(backbone_name, pvt_depths)
            channels = dict(zip(STAGES, BACKBONE_CHANNELS[backbone_name]))
            if use_pre_sam:
                self.pre_sam_backbone = _build_backbone(backbone_name, pvt_depths)
            self.audio_backbone = VGGish(width_mult=vggish_width)
            if use_pre_sam:
                self.scale_factor_module = nn.ModuleList(SqueezeExcite(d) for d in pre_sam_dim)
            if self.early:
                self.fusion_module = AVFuse(audio_dim, fused_backbone, fused_backbone_dim,
                                            fused_type)
                self.audio_transformation = AudioMLP(audio_out_dim, in_dim=AUDIO_FEATURE_DIM)
            self.sem_seg_head = MaskFormerHead(
                channels, num_classes, conv_dim=conv_dim, mask_dim=mask_dim,
                enc_layers=enc_layers, hidden_dim=hidden_dim, num_queries=num_queries,
                nheads=nheads, dim_feedforward=dim_feedforward, dec_layers=dec_layers,
                audio_dim=audio_dim, audio_out_dim=audio_out_dim,
                pixel_decoder_name=pixel_decoder_name, fusion_step=fusion_step,
                fused_type=fused_type, enforce_input_project=enforce_input_project,
                queries_fuse_type=queries_fuse_type, use_cosine_loss=use_cosine_loss)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] raw RGB -> normalized [N, 3, H, W] in x's float type
        (uint8 becomes float32)."""
        if not x.is_floating_point():
            x = x.float()
        mean = torch.tensor(PIXEL_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(PIXEL_STD, dtype=x.dtype, device=x.device)
        return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()

    def forward(
        self,
        images: torch.Tensor,  # [B, T, H, W, 3] raw RGB (0-255)
        audio_log_mel: torch.Tensor,  # [B, T, 96, 64]
        pre_masks: Optional[torch.Tensor] = None,  # [B, T, H, W, 3] Maskige RGB
        vid_temporal_mask: Optional[torch.Tensor] = None,  # [B, T] 0/1 per frame
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Dict[str, object]:
        B, T, H, W, _ = images.shape
        frames = self._normalize(images.reshape(B * T, H, W, 3))
        # [B*T, 1, 128]
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_audio):
            audio_feature = self.audio_backbone(audio_log_mel.reshape(B * T, 1, 96, 64))[:, None, :]
        if vid_temporal_mask is not None:
            audio_feature = audio_feature * vid_temporal_mask.reshape(B * T, 1, 1).to(
                audio_feature.dtype)

        features = self.backbone(frames, dropout_generator)
        if self.use_pre_sam:
            if pre_masks is None:
                raise ValueError("this model has the SEM tower: it needs pre_masks (Maskiges)")
            pre_feats = self.pre_sam_backbone(self._normalize(pre_masks.reshape(B * T, H, W, 3)),
                                              dropout_generator)
            for i, key in enumerate(sorted(features)):
                gate = self.scale_factor_module[i](pre_feats[key])
                features[key] = features[key] + gate * pre_feats[key]
        if self.early:
            features, audio = self.fusion_module(features, audio_feature, dropout_generator)
            audio_feature = self.audio_transformation(audio)
        return self.sem_seg_head(features, audio_feature, dropout_generator)


def semantic_inference(
    mask_cls: torch.Tensor,  # [N, Q, C+1]
    mask_pred: torch.Tensor,  # [N, Q, h, w]
    out_size: Optional[Tuple[int, int]] = None,
    temporal_mask: Optional[torch.Tensor] = None,  # [N]
) -> torch.Tensor:
    """softmax(cls)[..., :-1] x sigmoid(mask) semantic maps, optionally
    upsampled and weighted per frame by `temporal_mask`; returns [N, C, H, W]
    float32. On a CUDA tensor with at most `seminf_cuda.MAX_C` classes and an
    upsampling `out_size` the fused kernel computes it; otherwise, and always
    on the CPU, the plain composition (`seminf_cuda.semantic_inference_plain`).
    AVSS's 71 classes take the plain composition on the card too, as the
    JAX package leaves C > 8 to XLA's matmul (combo_avs_tpu/ops/
    seminf_pallas.py:40,53,97): no kernel computes them there either."""
    cls = _upcast32(mask_cls).softmax(-1)[..., :-1]
    if mask_pred.is_cuda and seminf_cuda.kernel_takes(cls.shape[-1], mask_pred.shape[2:],
                                                      out_size):
        return seminf_cuda.seminf_cuda(cls, mask_pred, out_size, temporal_mask)
    return seminf_cuda.semantic_inference_plain(cls, mask_pred, out_size,
                                                temporal_mask).float()


# what the port builds, by config key: any other value raises, as the JAX
# package's build_model and forward do (combo_avs_tpu/models/meta_arch.py:
# 213-250); `build_model` checks the widths that must agree
_BUILDS = {
    "META_ARCHITECTURE": ("MaskFormer",),
    "BACKBONE.NAME": tuple(BACKBONE_CHANNELS),
    "AUDIO.FREEZE_AUDIO_EXTRACTOR": (True, False),
    "PRE_SAM.USE_PRE_SAM": (True, False),
    "FUSE_CONFIG.FUSION_STEP": ("late", "early"),
    "FUSE_CONFIG.TYPE": FUSION_TYPES,
    "FUSE_CONFIG.QUERIES_FUSE_TYPE": QUERIES_FUSE_TYPES,
    "SEM_SEG_HEAD.NAME": ("MaskFormerHead",),
    "SEM_SEG_HEAD.PIXEL_DECODER_NAME": tuple(PIXEL_DECODERS),
    "SEM_SEG_HEAD.NORM": ("GN",),
    "SEM_SEG_HEAD.COMMON_STRIDE": (4,),
    "SEM_SEG_HEAD.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES": (["res3", "res4", "res5"],
                                                               ("res3", "res4", "res5")),
    "SEM_SEG_HEAD.DEFORMABLE_TRANSFORMER_ENCODER_N_POINTS": (4,),
    "MASK_FORMER.TRANSFORMER_DECODER_NAME": ("MultiScaleMaskedTransformerDecoder",),
    "MASK_FORMER.ENFORCE_INPUT_PROJ": (False, True),
}


def _cfg_get(node, dotted: str):
    for part in dotted.split("."):
        node = node[part]
    return node


# the PVT towers' depths that build_model gives (the JAX build_model always
# builds B5's); the CPU tests cut them
PVT_DEPTHS = B5_DEPTHS


def _check_fusion(m) -> None:
    """The fusion settings the JAX forward runs, else ValueError naming the
    key: the 12 `*-SemanticSegmentation.yaml` bases (early fusion, empty
    FUSED_BACKBONE_DIM) fail there on `max()` of an empty list; two
    different backbone levels on their level embedding, which has the first
    level's width; MHA-B and MHA-S-Audio on an AUDIO_DIM other than the
    VGGish embedding's 128."""
    f = m.FUSE_CONFIG
    early = f.FUSION_STEP == "early"
    names = list(f.FUSED_BACKBONE) if early else ["res2"]
    dims = list(f.FUSED_BACKBONE_DIM) if early else [m.SEM_SEG_HEAD.MASK_DIM]
    if not dims:
        raise ValueError("MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM is empty: early fusion needs "
                         "the width of each fused level (the JAX forward fails on max() of "
                         "an empty list)")
    if early:
        channels = dict(zip(STAGES, BACKBONE_CHANNELS[m.BACKBONE.NAME]))
        if len(names) != len(dims) or any(n not in channels for n in names):
            raise ValueError(f"MODEL.FUSE_CONFIG.FUSED_BACKBONE = {names!r} with "
                             f"FUSED_BACKBONE_DIM = {dims!r}: one width per backbone level")
        if len(set(names)) > 1:
            raise ValueError(f"MODEL.FUSE_CONFIG.FUSED_BACKBONE = {names!r}: early fusion over "
                             "different levels fails in the JAX forward (its level embedding "
                             "has one row, of the first level's width)")
        if [channels[n] for n in names] != dims:
            raise ValueError(f"MODEL.FUSE_CONFIG.FUSED_BACKBONE_DIM = {dims!r}: the widths of "
                             f"{names!r} are {[channels[n] for n in names]!r}")
    if f.TYPE in ("MHA-B", "MHA-S-Audio") and f.AUDIO_DIM != AUDIO_FEATURE_DIM:
        raise ValueError(f"MODEL.FUSE_CONFIG.AUDIO_DIM = {f.AUDIO_DIM!r}: {f.TYPE} fuses the "
                         f"{AUDIO_FEATURE_DIM}-wide VGGish embedding")


def build_model(cfg, device: Optional[torch.device | str] = None) -> MaskFormer:
    """The MaskFormer a config describes (the key surface of
    combo_avs_tpu/models/meta_arch.py::build_model, ref:
    maskformer_model.py:101-272 from_config), on `device`, else on
    MODEL.DEVICE ("cuda": the current CUDA device, raising without one).
    Builds every fusion step and type, query fusion, pixel decoder, the
    model with or without the SEM tower, the inter-frame loss and a frozen
    audio tower, as the JAX build_model does. Raises NotImplementedError,
    naming the key and its value, for a setting neither package builds, and
    ValueError for one the JAX forward fails on (`_check_fusion`) and for
    MASK_FORMER.PRE_NORM True, which the JAX decoder accepts but never reads
    (it runs post-norm whatever the flag says).

    The PVT backbone is B5 (MODEL.PVT.NAME "b5", all four OUT_FEATURES) at
    `PVT_DEPTHS`, with drop path 0.1: the JAX build_model passes no rate, so
    its PVTv2 always takes its default 0.1, and MODEL.PVT.DROP_PATH_RATE must
    say the same."""
    m = cfg.MODEL
    for key, allowed in _BUILDS.items():
        value = _cfg_get(m, key)
        if value not in allowed:
            raise NotImplementedError(f"MODEL.{key} = {value!r} is not built (the port builds "
                                      f"{list(allowed)!r})")
    if m.MASK_FORMER.PRE_NORM:
        raise ValueError("MODEL.MASK_FORMER.PRE_NORM = True: the JAX decoder never reads it "
                         "and runs post-norm; the port builds the post-norm decoder only "
                         "(PRE_NORM False)")
    checks = {
        "PIXEL_MEAN": (tuple(m.PIXEL_MEAN), PIXEL_MEAN),
        "PIXEL_STD": (tuple(m.PIXEL_STD), PIXEL_STD),
    }
    if m.BACKBONE.NAME == "build_resnet_backbone":
        checks.update({f"RESNETS.{k}": (m.RESNETS[k], v) for k, v in (
            ("DEPTH", 50), ("STEM_OUT_CHANNELS", 64), ("RES2_OUT_CHANNELS", 256),
            ("STRIDE_IN_1X1", False), ("NORM", "FrozenBN"))})
    if m.BACKBONE.NAME == "build_pvtv2_b5_backbone":
        checks.update({"PVT.NAME": (m.PVT.NAME, "b5"),
                       "PVT.OUT_FEATURES": (list(m.PVT.OUT_FEATURES),
                                            ["res2", "res3", "res4", "res5"]),
                       "PVT.DROP_PATH_RATE": (m.PVT.DROP_PATH_RATE, DROP_PATH_RATE)})
    for key, (value, want) in checks.items():
        if value != want:
            raise NotImplementedError(f"MODEL.{key} = {value!r} is not built (the port builds "
                                      f"{want!r})")
    _check_fusion(m)
    if m.PRE_SAM.USE_PRE_SAM and tuple(m.PRE_SAM.PRE_SAM_DIM) != BACKBONE_CHANNELS[
            m.BACKBONE.NAME]:
        raise ValueError(f"MODEL.PRE_SAM.PRE_SAM_DIM = {list(m.PRE_SAM.PRE_SAM_DIM)!r}: the SE "
                         f"gates take the backbone's widths "
                         f"{list(BACKBONE_CHANNELS[m.BACKBONE.NAME])!r}")
    if device is None:
        device = m.get("DEVICE", "cuda")
    if str(device) == "cuda":
        device = None  # the current CUDA device
    # ref: maskformer_model.py:168-171 gives the dim query fusion 128 and the
    # others HIDDEN_DIM (256 in every shipped config), as the JAX build_model
    dim_fusion = m.FUSE_CONFIG.QUERIES_FUSE_TYPE == "dim"
    return MaskFormer(
        backbone_name=m.BACKBONE.NAME,
        num_classes=m.SEM_SEG_HEAD.NUM_CLASSES,
        num_queries=m.MASK_FORMER.NUM_OBJECT_QUERIES,
        hidden_dim=m.MASK_FORMER.HIDDEN_DIM,
        nheads=m.MASK_FORMER.NHEADS,
        dim_feedforward=m.MASK_FORMER.DIM_FEEDFORWARD,
        dec_layers=m.MASK_FORMER.DEC_LAYERS - 1,
        enc_layers=m.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS,
        mask_dim=m.SEM_SEG_HEAD.MASK_DIM,
        conv_dim=m.SEM_SEG_HEAD.CONVS_DIM,
        audio_dim=m.FUSE_CONFIG.AUDIO_DIM,
        audio_out_dim=AUDIO_FEATURE_DIM if dim_fusion else m.MASK_FORMER.HIDDEN_DIM,
        pre_sam_dim=tuple(m.PRE_SAM.PRE_SAM_DIM),
        vggish_width=m.AUDIO.get("WIDTH_MULT", 1.0),
        pvt_depths=PVT_DEPTHS,
        use_pre_sam=m.PRE_SAM.USE_PRE_SAM,
        freeze_audio=m.AUDIO.FREEZE_AUDIO_EXTRACTOR,
        fusion_step=m.FUSE_CONFIG.FUSION_STEP,
        fused_type=m.FUSE_CONFIG.TYPE,
        fused_backbone=tuple(m.FUSE_CONFIG.FUSED_BACKBONE),
        fused_backbone_dim=tuple(m.FUSE_CONFIG.FUSED_BACKBONE_DIM),
        queries_fuse_type=m.FUSE_CONFIG.QUERIES_FUSE_TYPE,
        enforce_input_project=m.MASK_FORMER.ENFORCE_INPUT_PROJ,
        use_cosine_loss=m.MASK_FORMER.COSINE_WEIGHT > 0,
        pixel_decoder_name=m.SEM_SEG_HEAD.PIXEL_DECODER_NAME,
        device=default_device(device),
    )
