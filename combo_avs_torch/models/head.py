"""MaskFormerHead: pixel decoder + late MHA-B fusion + masked-attention decoder.

Port of `combo_avs_tpu/models/head.py` for the late-fusion, MSDeformAttn
pixel-decoder configuration: the stride-4 `mask_features` map is fused with
the audio vector, the fused audio goes through the 128 -> 4096 -> 4096 ->
hidden MLP, and the predictor runs over the 3 multi-scale maps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from combo_avs_torch.models.fusion import AudioMLP, AVFuse
from combo_avs_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from combo_avs_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder


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
    ):
        super().__init__()
        if conv_dim != hidden_dim or audio_out_dim != hidden_dim:
            # the predictor's input_proj and the "dim" query fusion are not ported
            raise ValueError("conv_dim and audio_out_dim must equal hidden_dim")
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels, conv_dim=conv_dim, mask_dim=mask_dim, enc_layers=enc_layers,
            n_heads=nheads)
        self.fusion_module = AVFuse(audio_dim, ("res2",), (mask_dim,))
        self.audio_transformation = AudioMLP(audio_out_dim, in_dim=audio_dim)
        self.predictor = MultiScaleMaskedTransformerDecoder(
            num_classes, hidden_dim=hidden_dim, num_queries=num_queries, nheads=nheads,
            dim_feedforward=dim_feedforward, dec_layers=dec_layers, mask_dim=mask_dim)

    def forward(self, features: Dict[str, torch.Tensor], audio_feature: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        mask_features, _, multi_scale_features = self.pixel_decoder(features)
        fused, audio = self.fusion_module({"res2": mask_features}, audio_feature, generator)
        audio = self.audio_transformation(audio)
        return self.predictor(multi_scale_features, audio, fused["res2"])
