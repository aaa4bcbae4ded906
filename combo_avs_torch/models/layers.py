"""Shared building blocks and the seeded initializers that follow flax's.

The JAX package initializes with flax's defaults (`lecun_normal` kernels,
zero biases) unless a module names another initializer; the helpers here
reproduce those distributions with an explicit `torch.Generator`, so a seed
gives the same weights on any device of the same kind, and random-weight
activations keep the JAX model's scale.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated_normal variance_scaling divides by this (the std of a unit
# normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978


def _fans(t: torch.Tensor):
    """(fan_in, fan_out) of a torch Linear [out, in] or Conv [out, in, kh, kw]
    weight; equal to flax's fans of the transposed [in, out] / HWIO kernel."""
    receptive = t[0][0].numel() if t.dim() > 2 else 1
    return t.shape[1] * receptive, t.shape[0] * receptive


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal`: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / _fans(t)[0]) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(t)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-bound, bound, generator=g)


@torch.no_grad()
def init_xavier(m: nn.Module, g: torch.Generator) -> None:
    """xavier_uniform weight, zero bias (a flax Dense/Conv with
    kernel_init=xavier_uniform)."""
    xavier_uniform_(m.weight, g)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init of every parameter and frozen buffer, on the model's own
    device. First every Linear/Conv2d gets flax's default (lecun_normal
    weight, zero bias) and every norm ones/zeros; then each module that
    defines `init_params(generator)` applies the initializers the JAX module
    names for its own tensors (xavier, zero kernels, normal embeddings...)."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(g)
    return model


class Conv2d(nn.Conv2d):
    """Conv2d with an optional norm applied to its output, so that the norm's
    state-dict keys sit under the conv's (`res2.0.conv1.norm.running_mean`,
    `adapter_1.norm.weight`), as in the reference checkpoints."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x):
        x = super().forward(x)
        return x if self.norm is None else self.norm(x)


class SqueezeExcite(nn.Module):
    """SE channel gate of the Siam-Encoder Module: GAP -> FC(dim/16) -> ReLU
    -> FC(dim) -> sigmoid, returned as a per-channel gate [B, C, 1, 1]."""

    def __init__(self, dim: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim // reduction)
        self.fc2 = nn.Linear(dim // reduction, dim)

    def forward(self, x):  # [B, C, H, W]
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        return y[:, :, None, None]


class DropPath(nn.Module):
    """Stochastic depth: in training mode, zero a whole sample's residual
    branch with probability `rate` and scale the survivors by 1 / (1 - rate)
    (`combo_avs_tpu/models/layers.py::DropPath`, timm's). The rate comes with
    each call, since each PVT block has its own, and the mask is drawn from
    the call's `generator`, never from the global RNG. The identity in eval
    mode and at rate 0."""

    def forward(self, x: torch.Tensor, rate: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or rate == 0.0:
            return x
        if generator is None:
            raise ValueError("drop path in training mode needs an explicit torch.Generator")
        keep = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                          device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


class MLP(nn.Module):
    """Multi-layer perceptron with ReLU between layers (the mask-embed head)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
