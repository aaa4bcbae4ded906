"""Seeded weights under the reference checkpoints' key names.

One `torch.randn` on the device over all tensors at once, scaled and
shifted per tensor by two multi-tensor calls:
weight matrices and kernels N(0, 1/fan_in), biases N(0, 0.02^2), norm
scales 1 + N(0, 0.1^2), norm shifts and frozen BatchNorm means N(0, 0.1^2),
frozen BatchNorm variances 1 + N(0, 0.1^2), embeddings and the pixel
decoder's level embedding N(0, 1), the fusion's layer scales 0.1 + N(0,
0.01^2). The same seed gives the same tensors, so a run regenerates them
whenever it needs the starting point again instead of keeping a copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from h100_bench.reference.model import FrozenBN


def schema(model: nn.Module) -> List[Tuple[str, torch.Size, float, float]]:
    """(key, shape, scale, shift) of every tensor of the reference's
    state dict, in its order."""
    kind = {}
    for mname, module in model.named_modules():
        for tname, t in list(module.named_parameters(recurse=False)) + list(
                module.named_buffers(recurse=False)):
            key = f"{mname}.{tname}".lstrip(".")
            if isinstance(module, FrozenBN):
                kind[key] = {"weight": (0.1, 1.0), "bias": (0.1, 0.0), "running_mean": (0.1, 0.0),
                             "running_var": (0.1, 1.0)}[tname]
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
                kind[key] = (0.1, 1.0) if tname == "weight" else (0.1, 0.0)
            elif isinstance(module, nn.Embedding) or tname == "level_embed":
                kind[key] = (1.0, 0.0)
            elif "gamma" in mname or "gamma" in tname:
                kind[key] = (0.01, 0.1)
            elif t.dim() >= 2:
                fan_in = t[0].numel()
                kind[key] = (fan_in ** -0.5, 0.0)
            else:
                kind[key] = (0.02, 0.0)
    return [(k, v.shape, *kind[k]) for k, v in model.state_dict().items()]


def make(model_schema, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict for `seed`: views into one flat tensor on `device`,
    scaled and shifted in place (no second copy, so set-up's peak memory is
    the weights once)."""
    sizes = [s.numel() for _, s, _, _ in model_schema]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
    out, start = {}, 0
    for (key, shape, _, _), n in zip(model_schema, sizes):
        out[key] = flat[start:start + n].view(shape)
        start += n
    views = list(out.values())
    torch._foreach_mul_(views, [c for _, _, c, _ in model_schema])
    torch._foreach_add_(views, [b for _, _, _, b in model_schema])
    return out
