"""VGGish audio embedding network, NCHW.

Port of `combo_avs_tpu/models/vggish.py`: a VGG conv stack
[64, M, 128, M, 256, 256, M, 512, 512, M] over a [96, 64] log-mel patch, then
FC 512*6*4 -> 4096 -> 4096 -> 128, ReLU after every layer. Module indices
follow the torchvggish checkpoints (`features.{0,3,6,8,11,13}`,
`embeddings.{0,2,4}`).

The FC weights expect the conv output flattened in NHWC order ([N, 6, 4, 512],
the TF layout the JAX package uses natively), so the NCHW map is permuted
before it is flattened.
"""

from __future__ import annotations

import torch
from torch import nn

VGG_LAYERS = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M")
EMBEDDING_SIZE = 128


class VGGish(nn.Module):
    """[N, 1, 96, 64] log-mel -> [N, 128]. `width_mult` scales the conv
    channels and FC width (1.0 is the parity architecture; smaller values are
    for tests)."""

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        layers = []
        cin = 1
        for v in VGG_LAYERS:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                ch = max(8, int(round(int(v) * width_mult)))
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
        self.features = nn.Sequential(*layers)
        fc = max(32, int(round(4096 * width_mult)))
        self.embeddings = nn.Sequential(
            nn.Linear(6 * 4 * cin, fc), nn.ReLU(),
            nn.Linear(fc, fc), nn.ReLU(),
            nn.Linear(fc, EMBEDDING_SIZE), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)  # [N, C, 6, 4]
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC order, as the FC weights expect
        return self.embeddings(x)
