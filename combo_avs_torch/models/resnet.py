"""ResNet visual backbone (detectron2 layout), NCHW.

Port of `combo_avs_tpu/models/resnet.py`: 7x7/2 stem + 3x3/2 max-pool,
bottleneck stages with the stage stride on the first block's 3x3 conv
(STRIDE_IN_1X1 False), FrozenBatchNorm everywhere, outputs res2..res5.
Module names follow the reference checkpoints (`stem.conv1`, `res2.0.conv1`,
`res2.0.conv1.norm`, `res2.0.shortcut`), which
`combo_avs_tpu/train/checkpoint.py::convert_d2_resnet` reads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from combo_avs_torch.models.layers import Conv2d

# depth 10 = one bottleneck per stage: the tiny test backbone, not a reference config
BLOCKS_PER_STAGE = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3)}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine, all four kept as buffers
    (`weight`, `bias`, `running_mean`, `running_var`)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def init_params(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):  # [B, C, H, W]
        # the scale is formed in the buffers' type, then cast, as the JAX module does
        inv = (self.weight / torch.sqrt(self.running_var + self.eps)).to(x.dtype)
        shift = (self.bias - self.running_mean * inv).to(x.dtype)
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def _conv(cin: int, cout: int, kernel: int, stride: int) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False,
                  norm=FrozenBatchNorm(cout))


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int = 1,
                 has_shortcut: bool = False):
        super().__init__()
        self.shortcut = _conv(cin, cout, 1, stride) if has_shortcut else None
        self.conv1 = _conv(cin, bottleneck, 1, 1)
        self.conv2 = _conv(bottleneck, bottleneck, 3, stride)
        self.conv3 = _conv(bottleneck, cout, 1, 1)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


class _Stem(nn.Module):
    def __init__(self, cout: int):
        super().__init__()
        self.conv1 = _conv(3, cout, 7, 2)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class ResNet(nn.Module):
    """[B, 3, H, W] -> {"res2": [B, 256, H/4, W/4], ..., "res5": [B, 2048, H/32, W/32]}
    (channels for depth 50 with the default widths)."""

    def __init__(self, depth: int = 50, stem_out_channels: int = 64,
                 res2_out_channels: int = 256):
        super().__init__()
        self.stem = _Stem(stem_out_channels)
        cin, out_ch = stem_out_channels, res2_out_channels
        bottleneck = out_ch // 4
        self.stage_names = []
        for stage_idx, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            stride = 1 if stage_idx == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(BottleneckBlock(cin, bottleneck, out_ch,
                                              stride=stride if b == 0 else 1,
                                              has_shortcut=b == 0))
                cin = out_ch
            name = f"res{stage_idx + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            bottleneck *= 2
            out_ch *= 2

    def forward(self, x, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """`generator` is the towers' common signature (the PVT tower draws
        its drop path from it); a FrozenBN ResNet draws nothing."""
        x = self.stem(x)
        outputs = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            outputs[name] = x
        return outputs
