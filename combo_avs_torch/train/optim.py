"""Optimizer and LR schedule.

Port of `combo_avs_tpu/train/optim.py`, whose optax chain is

  clip_by_global_norm(CLIP_VALUE) -> scale_by_adam(0.9, 0.999, 1e-8)
    -> add_decayed_weights(wd per parameter) -> scale_by_learning_rate(schedule)
    -> x lr multiplier per parameter,

or for SOLVER.OPTIMIZER SGD the same chain with `trace(decay=MOMENTUM)` in
place of scale_by_adam.

`torch.optim.AdamW` with one group per (lr multiplier, weight decay) and the
group's lr set to schedule(step) x multiplier before each step computes the
same update: p -= lr * mult * (adam(g) + wd * p). For SGD, `TraceSGD`
writes the chain out: buf = g + momentum * buf, then p -= lr * mult * (buf +
wd * p), the decay added after the momentum (`torch.optim.SGD` folds it into
the momentum buffer, another update). A parameter with no gradient (one the
loss does not reach, as the unused `query_feat` of the "all" query fusion)
takes a zero gradient, as the JAX chain gives it: it still decays. The clip
is written out as optax's `g * min(1, c / ||g||)` with no epsilon
(`clip_grad_norm_` adds 1e-6 to the norm).

Parameter groups follow the reference's rules by module type and name:
parameters of norm modules get WEIGHT_DECAY_NORM, `nn.Embedding` tables
WEIGHT_DECAY_EMBED (the pixel decoder's `level_embed` is a plain parameter
and keeps the default decay), `relative_position_bias_table` and
`absolute_pos_embed` none; parameters under a "backbone" module take the
backbone lr multiplier (the VGGish tower, "audio_backbone", among them when it
trains); a frozen VGGish tower gets no group.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

NORM_MODULE_TYPES = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.SyncBatchNorm,
                     nn.GroupNorm, nn.InstanceNorm1d, nn.InstanceNorm2d, nn.InstanceNorm3d,
                     nn.LayerNorm, nn.LocalResponseNorm)
ZERO_WD_NAMES = ("relative_position_bias_table", "absolute_pos_embed")
FROZEN_MODULES = ("audio_backbone",)


def warmup_poly_schedule(base_lr: float, max_iter: int, warmup_iters: int = 0,
                         warmup_factor: float = 1.0, power: float = 0.9,
                         constant_ending: float = 0.0) -> Callable[[int], float]:
    """d2 WarmupPolyLR: base * warmup(t) * (1 - t / max_iter)^power."""

    def schedule(count: int) -> float:
        t = min(count, max_iter)
        if warmup_iters > 0:
            alpha = min(max(t / warmup_iters, 0.0), 1.0)
            warm = warmup_factor * (1 - alpha) + alpha
        else:
            warm = 1.0
        poly = max(1.0 - t / max_iter, 0.0) ** power
        if constant_ending > 0:
            poly = max(poly, constant_ending)
        return base_lr * warm * poly

    return schedule


def param_groups(model: nn.Module, weight_decay: float, weight_decay_norm: float,
                 weight_decay_embed: float, backbone_multiplier: float,
                 freeze_audio: bool = True) -> List[Dict]:
    """The trainable parameters by the reference's rules, one group per
    (lr multiplier, weight decay): {"params", "names", "lr_multiplier",
    "weight_decay"}. Parameters with requires_grad=False and, with
    `freeze_audio`, the audio tower are in none. The reference makes a group
    per parameter; merging
    equal ones changes no update, and AdamW then updates a group with a few
    multi-tensor kernels instead of several kernels per parameter."""
    groups: Dict[tuple, Dict] = {}
    seen = set()
    for module_name, module in model.named_modules():
        if freeze_audio and any(f in module_name.split(".") for f in FROZEN_MODULES):
            continue
        for pname, p in module.named_parameters(recurse=False):
            if not p.requires_grad or id(p) in seen:
                continue
            seen.add(id(p))
            wd = weight_decay
            if any(k in pname for k in ZERO_WD_NAMES):
                wd = 0.0
            if isinstance(module, NORM_MODULE_TYPES):
                wd = weight_decay_norm
            if isinstance(module, nn.Embedding):
                wd = weight_decay_embed
            mult = backbone_multiplier if "backbone" in module_name else 1.0
            g = groups.setdefault((mult, wd), {"params": [], "names": [], "lr_multiplier": mult,
                                               "weight_decay": wd})
            g["params"].append(p)
            g["names"].append(f"{module_name}.{pname}".lstrip("."))
    return list(groups.values())


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by min(1, max_norm / ||grads||) (one L2 norm
    over all of them), as optax's clip_by_global_norm; returns the norm. No
    host synchronization."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class TraceSGD(torch.optim.Optimizer):
    """optax's `trace(decay=momentum)` followed by the per-group decoupled
    weight decay and the group's lr: buf = g + momentum * buf (buf starts at
    zero), p -= lr * (buf + weight_decay * p). Every parameter of a group
    needs a gradient."""

    def __init__(self, params, lr: float, momentum: float):
        super().__init__(params, {"lr": lr, "momentum": momentum, "weight_decay": 0.0})

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            ps = g["params"]
            for p in ps:
                if "momentum_buffer" not in self.state[p]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(p)
            bufs = [self.state[p]["momentum_buffer"] for p in ps]
            torch._foreach_mul_(bufs, g["momentum"])
            torch._foreach_add_(bufs, [p.grad for p in ps])
            upd = torch._foreach_add(bufs, ps, alpha=g["weight_decay"])
            torch._foreach_add_(ps, upd, alpha=-g["lr"])


class Optimizer:
    """Clipped AdamW, or clipped momentum SGD, with the reference's
    parameter groups and schedule; `inner` is the torch optimizer.

    S4 defaults: SOLVER of combo_avs_tpu/configs/avs_s4/
    R50-AVSS4-SemanticSegmentation.yaml:32-46 (BASE_LR 1e-4, MAX_ITER 90000,
    no warmup, WEIGHT_DECAY 0.05, BACKBONE_MULTIPLIER 0.1, full-model clip
    0.01) and WEIGHT_DECAY_NORM / WEIGHT_DECAY_EMBED 0, POLY_LR_POWER 0.9
    and MOMENTUM 0.9 of combo_avs_tpu/config.py:407-414."""

    def __init__(self, model: nn.Module, base_lr: float = 1e-4, max_iter: int = 90000,
                 warmup_iters: int = 0, warmup_factor: float = 1.0, power: float = 0.9,
                 weight_decay: float = 0.05, weight_decay_norm: float = 0.0,
                 weight_decay_embed: float = 0.0, backbone_multiplier: float = 0.1,
                 clip_value: float = 0.01, constant_ending: float = 0.0,
                 name: str = "ADAMW", momentum: float = 0.9, freeze_audio: bool = True):
        self.groups = param_groups(model, weight_decay, weight_decay_norm, weight_decay_embed,
                                   backbone_multiplier, freeze_audio)
        self.schedule = warmup_poly_schedule(base_lr, max_iter, warmup_iters, warmup_factor,
                                             power, constant_ending)
        self.clip_value = clip_value
        self.name = name.upper()
        if self.name == "ADAMW":
            self.inner = torch.optim.AdamW(self.groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
        elif self.name == "SGD":
            self.inner = TraceSGD(self.groups, lr=base_lr, momentum=momentum)
        else:
            raise NotImplementedError(f"SOLVER.OPTIMIZER = {name!r}: ADAMW or SGD")
        self.params = [p for g in self.inner.param_groups for p in g["params"]]
        self.count = 0  # updates taken, as optax's schedule count

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the parameters' `.grad`: a zero gradient where
        there is none, clip, set each group's lr to schedule(count) x its
        multiplier, the update."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_value > 0 and self.params:
            clip_by_global_norm_([p.grad for p in self.params], self.clip_value)
        lr = self.schedule(self.count)
        for g in self.inner.param_groups:
            g["lr"] = lr * g["lr_multiplier"]
        self.inner.step()
        self.count += 1


def build_optimizer(cfg, model: nn.Module) -> Optimizer:
    """The optimizer a config's SOLVER describes
    (combo_avs_tpu/train/optim.py::build_optimizer): AdamW or SGD (MOMENTUM)
    with the reference's groups (the audio tower's among them unless
    MODEL.AUDIO.FREEZE_AUDIO_EXTRACTOR), WarmupPolyLR, and the full-model
    gradient clip when CLIP_GRADIENTS is on. Raises NotImplementedError for
    an optimizer or schedule neither package has, and for a clip type other
    than full_model, which the JAX package skips without a word (its chain
    then has no clip) rather than applying."""
    s = cfg.SOLVER
    if s.OPTIMIZER.upper() not in ("ADAMW", "SGD"):
        raise NotImplementedError(f"SOLVER.OPTIMIZER = {s.OPTIMIZER!r}: ADAMW or SGD")
    if s.get("LR_SCHEDULER_NAME", "WarmupPolyLR") != "WarmupPolyLR":
        raise NotImplementedError(f"SOLVER.LR_SCHEDULER_NAME = {s.LR_SCHEDULER_NAME!r} is not "
                                  "ported yet (the port has WarmupPolyLR)")
    clip = s.CLIP_GRADIENTS
    if clip.ENABLED and clip.CLIP_TYPE != "full_model":
        raise NotImplementedError(f"SOLVER.CLIP_GRADIENTS.CLIP_TYPE = {clip.CLIP_TYPE!r} is not "
                                  "ported yet (the port clips the full model)")
    return Optimizer(model, base_lr=s.BASE_LR, max_iter=s.MAX_ITER, warmup_iters=s.WARMUP_ITERS,
                     warmup_factor=s.WARMUP_FACTOR, power=s.get("POLY_LR_POWER", 0.9),
                     weight_decay=s.WEIGHT_DECAY, weight_decay_norm=s.WEIGHT_DECAY_NORM,
                     weight_decay_embed=s.WEIGHT_DECAY_EMBED,
                     backbone_multiplier=s.BACKBONE_MULTIPLIER,
                     clip_value=clip.CLIP_VALUE if clip.ENABLED else 0.0,
                     constant_ending=s.get("POLY_LR_CONSTANT_ENDING", 0.0),
                     name=s.OPTIMIZER, momentum=s.get("MOMENTUM", 0.9),
                     freeze_audio=cfg.MODEL.AUDIO.FREEZE_AUDIO_EXTRACTOR)
