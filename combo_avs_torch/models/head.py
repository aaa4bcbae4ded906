"""MaskFormerHead: pixel decoder + late fusion + masked-attention decoder.

Port of `combo_avs_tpu/models/head.py`: the pixel decoder chosen by name
(`PIXEL_DECODERS`: the deformable one, or an FPN of `fpn_decoder.py`); with
late fusion the stride-4 `mask_features` map is fused with the audio vector
by the fusion type and the fused audio goes through the 128 -> 4096 -> 4096
-> audio_out_dim MLP (with early fusion the meta-architecture has done both);
then the predictor runs over the 3 multi-scale maps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from combo_avs_torch.models.fpn_decoder import PIXEL_DECODERS as FPN_DECODERS
from combo_avs_torch.models.fusion import AUDIO_FEATURE_DIM, AudioMLP, AVFuse
from combo_avs_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from combo_avs_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder
from combo_avs_torch.utils import profiling

PIXEL_DECODERS = {"MSDeformAttnPixelDecoder": MSDeformAttnPixelDecoder, **FPN_DECODERS}


class MaskFormerHead(nn.Module):
    def __init__(
        self,
        in_channels: Dict[str, int],
        num_classes: int,
        conv_dim: int = 256,
        mask_dim: int = 256,
        enc_layers: int = 6,
        hidden_dim: int = 256,
        num_queries: int = 100,
        nheads: int = 8,
        dim_feedforward: int = 2048,
        dec_layers: int = 9,
        audio_dim: int = 128,
        audio_out_dim: int = 256,
        pixel_decoder_name: str = "MSDeformAttnPixelDecoder",
        fusion_step: str = "late",
        fused_type: str = "MHA-B",
        enforce_input_project: bool = False,
        queries_fuse_type: str = "add",
        use_cosine_loss: bool = True,
    ):
        super().__init__()
        if pixel_decoder_name not in PIXEL_DECODERS:
            raise ValueError(f"pixel decoder {pixel_decoder_name!r}: one of "
                             f"{sorted(PIXEL_DECODERS)}")
        if pixel_decoder_name == "MSDeformAttnPixelDecoder":
            self.pixel_decoder = MSDeformAttnPixelDecoder(
                in_channels, conv_dim=conv_dim, mask_dim=mask_dim, enc_layers=enc_layers,
                n_heads=nheads)
        else:  # the JAX head gives the FPN decoders their widths only
            self.pixel_decoder = PIXEL_DECODERS[pixel_decoder_name](
                in_channels, conv_dim=conv_dim, mask_dim=mask_dim)
        self.late = fusion_step == "late"
        if self.late:
            self.fusion_module = AVFuse(audio_dim, ("res2",), (mask_dim,), fused_type)
            self.audio_transformation = AudioMLP(audio_out_dim, in_dim=AUDIO_FEATURE_DIM)
        self.predictor = MultiScaleMaskedTransformerDecoder(
            num_classes, hidden_dim=hidden_dim, num_queries=num_queries, nheads=nheads,
            dim_feedforward=dim_feedforward, dec_layers=dec_layers, mask_dim=mask_dim,
            in_channels=conv_dim, enforce_input_project=enforce_input_project,
            queries_fuse_type=queries_fuse_type, audio_out_dim=audio_out_dim,
            use_cosine_loss=use_cosine_loss)

    def forward(self, features: Dict[str, torch.Tensor], audio_feature: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        with profiling.span("combo.forward.pixel_decoder"):
            mask_features, _, multi_scale_features = self.pixel_decoder(features)
        if self.late:
            with profiling.span("combo.forward.fusion"):
                fused, audio = self.fusion_module({"res2": mask_features}, audio_feature,
                                                  generator)
                mask_features = fused["res2"]
                audio_feature = self.audio_transformation(audio)
        with profiling.span("combo.forward.predictor"):
            return self.predictor(multi_scale_features, audio_feature, mask_features)
