"""The plain reference of COMBO-AVS training: matcher, criterion and the
clipped AdamW update.

Upstream Mask2Former's set criterion (ref: criterion.py, matcher.py) as the
COMBO configs run it: Hungarian matching on one shared set of uniform
points per frame (class, sigmoid-CE and dice costs; the assignment by
scipy's `linear_sum_assignment` on the host), the class loss with the
no-object weight, PointRend mask and dice losses on uncertainty-selected
points, and the adaptive inter-frame cosine loss; S4's per-frame weights
(`gt_temporal_mask`). The random draws (matcher points, oversampled
candidates, the random tail) are given, one triple per decoder output.

Departure, as the configuration states it (MODEL.MASK_FORMER.
EXACT_TOPK_POINTS false, the repository's accelerator selection): the most
uncertain points are chosen per chunk of 256 candidates, a fixed quota
each, not by one top-k over all candidates.

Imports torch, numpy and scipy only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from h100_bench.reference.model import FrozenBN


def point_sample(img: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """img [N, C, H, W] at points [N, P, 2] (x, y in [0, 1]) -> [N, C, P]
    (F.grid_sample, bilinear, zero padding, align_corners False)."""
    return F.grid_sample(img, (2.0 * points - 1.0)[:, :, None, :].to(img.dtype),
                         mode="bilinear", padding_mode="zeros", align_corners=False)[..., 0]


def _bce_mean(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="none").mean(-1)


def _dice(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    p = logits.sigmoid()
    return 1.0 - (2.0 * (p * targets).sum(-1) + 1.0) / (p.sum(-1) + targets.sum(-1) + 1.0)


class Criterion:
    """Losses of one training forward. `spec` is the configuration file's
    `criterion` section."""

    def __init__(self, spec: Dict):
        self.spec = spec
        self.num_classes = spec["num_classes"]

    @torch.no_grad()
    def match(self, logits, masks, labels, tgt, valid, points) -> List[np.ndarray]:
        """Per frame, the query index of each valid slot (-1 elsewhere)."""
        s = self.spec
        N, Q, _ = logits.shape
        prob = logits.float().softmax(-1)
        out = point_sample(masks.float(), points)  # [N, Q, P]
        tpts = point_sample(tgt, points)  # [N, K, P]
        cost = []
        for n in range(N):
            c_cls = -prob[n][:, labels[n]]  # [Q, K]
            o, t = out[n], tpts[n]
            pos = torch.logaddexp(-o, torch.zeros_like(o))
            neg = torch.logaddexp(o, torch.zeros_like(o))
            c_mask = (pos @ t.T + neg @ (1.0 - t).T) / o.shape[-1]
            p = o.sigmoid()
            c_dice = 1.0 - (2.0 * (p @ t.T) + 1.0) / (p.sum(-1)[:, None] + t.sum(-1)[None, :] + 1.0)
            cost.append(s["cost_class"] * c_cls + s["cost_mask"] * c_mask + s["cost_dice"] * c_dice)
        cost = torch.stack(cost).cpu().numpy()
        valid = valid.cpu().numpy()
        assign = []
        for n in range(N):
            a = np.full(valid.shape[1], -1, np.int64)
            ks = np.flatnonzero(valid[n])
            if len(ks):
                rows, cols = linear_sum_assignment(cost[n][:, ks].T)
                a[ks[rows]] = cols
            assign.append(a)
        return assign

    def selected_points(self, src: torch.Tensor, candidates: torch.Tensor,
                        tail: torch.Tensor) -> torch.Tensor:
        """The uncertain candidates (per chunk of `point_chunk`, the `quota`
        with the smallest |logit|, in stable order; with `exact_topk` the
        smallest over all candidates) followed by the random tail."""
        s = self.spec
        n_unc = int(s["num_points"] * s["importance_sample_ratio"])
        ch = s["point_chunk"]
        M, NS, _ = candidates.shape
        quota = n_unc * ch // NS
        with torch.no_grad():
            lg = point_sample(src[:, None].detach(), candidates)[:, 0]  # [M, NS]
            if s["exact_topk"]:
                idx = torch.topk(-lg.abs(), n_unc, dim=-1).indices
                top = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, 2))
                return torch.cat([top, tail.to(top.dtype)], 1)
            order = torch.sort(lg.abs().reshape(M, NS // ch, ch), dim=-1, stable=True).indices
            keep = order[..., :quota]
            xy = candidates.reshape(M, NS // ch, ch, 2)
            top = torch.gather(xy, 2, keep[..., None].expand(-1, -1, -1, 2)).reshape(M, -1, 2)
        return torch.cat([top, tail.to(top.dtype)], 1)

    def __call__(self, outputs: Dict, labels: torch.Tensor, tgt_masks: torch.Tensor,
                 valid: torch.Tensor, frame_weight: torch.Tensor,
                 draws: Sequence) -> Dict[str, torch.Tensor]:
        """labels [N, K], tgt_masks [N, K, H, W] float, valid [N, K] bool,
        frame_weight [N]; draws: (points [N, MP, 2], candidates [N*K, 3P,
        2], tail [N*K, P/4, 2]) for the final output, then each aux one."""
        s = self.spec
        N, K = labels.shape
        valid = valid & (frame_weight[:, None] > 0)
        num_masks = max(float(valid.sum()), 1.0)
        layers = [(outputs["pred_logits"], outputs["pred_masks"], "")] + [
            (a["pred_logits"], a["pred_masks"], f"_{i}")
            for i, a in enumerate(outputs["aux_outputs"])]
        losses = {}
        for (logits, masks, suffix), (pts, cand, tail) in zip(layers, draws):
            assign = self.match(logits, masks, labels, tgt_masks, valid, pts)
            Q = logits.shape[1]
            target = torch.full((N, Q), self.num_classes, dtype=torch.long, device=logits.device)
            rows, srcs, slots = [], [], []
            for n, a in enumerate(assign):
                for k in np.flatnonzero(a >= 0):
                    target[n, int(a[k])] = labels[n, k]
                    rows.append(n)
                    srcs.append(int(a[k]))
                    slots.append(int(k))
            w_cls = torch.ones(self.num_classes + 1, device=logits.device)
            w_cls[-1] = s["no_object_weight"]
            nll = F.cross_entropy(logits.float().transpose(1, 2), target, reduction="none")
            w = w_cls[target] * frame_weight[:, None]
            losses[f"loss_ce{suffix}"] = (nll * w).sum() / w.sum()
            r = torch.tensor(rows, device=logits.device)
            m = r * K + torch.tensor(slots, device=logits.device)
            src = masks[r, torch.tensor(srcs, device=logits.device)].float()  # [V, h, w]
            coords = self.selected_points(src, cand[m], tail[m])
            with torch.no_grad():
                plabels = point_sample(tgt_masks[r, torch.tensor(slots, device=r.device)][:, None],
                                       coords)[:, 0]
            plogits = point_sample(src[:, None], coords)[:, 0]
            losses[f"loss_mask{suffix}"] = _bce_mean(plogits, plabels).sum() / num_masks
            losses[f"loss_dice{suffix}"] = _dice(plogits, plabels).sum() / num_masks
        nf = s["cosine_frames"]
        for i, middle in enumerate(outputs["middles_attn_mask"]):
            mm = middle.float().reshape(N // nf, nf, -1)
            total = 0.0
            for f in range(nf - 1):
                a, b = mm[:, f], mm[:, f + 1]
                d = 1.0 - (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(min=1e-8)
                total = total + d * torch.exp(-d)
            losses[f"loss_cosine_{i}"] = total.sum() / (N // nf) / (nf - 1)
        return losses


def weight_dict(spec: Dict) -> Dict[str, float]:
    base = {"loss_ce": spec["class_weight"], "loss_mask": spec["mask_weight"],
            "loss_dice": spec["dice_weight"]}
    out = dict(base)
    for i in range(spec["dec_layers"] - 1):
        out.update({f"{k}_{i}": v for k, v in base.items()})
        out[f"loss_cosine_{i}"] = spec["cosine_weight"]
    return out


def param_groups(model: nn.Module, spec: Dict) -> Dict[str, tuple]:
    """name -> (lr multiplier, weight decay) of each trained parameter
    (ref: d2 build_optimizer with Mask2Former's rules): norm layers and
    embeddings take no decay, a module under a "backbone" the backbone
    multiplier; the frozen audio tower takes no group."""
    out = {}
    for mname, module in model.named_modules():
        if "audio_backbone" in mname.split("."):
            continue
        for pname, p in module.named_parameters(recurse=False):
            wd = spec["weight_decay"]
            if isinstance(module, (nn.LayerNorm, nn.GroupNorm, FrozenBN)):
                wd = spec["weight_decay_norm"]
            if isinstance(module, nn.Embedding):
                wd = spec["weight_decay_embed"]
            mult = spec["backbone_multiplier"] if "backbone" in mname else 1.0
            out[f"{mname}.{pname}".lstrip(".")] = (mult, wd)
    return out


class AdamW:
    """Full-model gradient clip (g * min(1, c / ||g||)), then AdamW with
    per-parameter lr multipliers and decoupled weight decay, and the poly
    learning rate (WarmupPolyLR with no warm-up), written out."""

    def __init__(self, model: nn.Module, spec: Dict):
        self.spec = spec
        self.params = {n: p for n, p in model.named_parameters()}
        self.groups = param_groups(model, spec)
        self.m = {n: torch.zeros_like(self.params[n]) for n in self.groups}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.groups}
        self.t = 0

    def lr(self) -> float:
        s = self.spec
        return s["base_lr"] * max(1.0 - self.t / s["max_iter"], 0.0) ** s["poly_power"]

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Returns the clipped gradient of each trained parameter."""
        s = self.spec
        grads = {n: (self.params[n].grad if self.params[n].grad is not None
                     else torch.zeros_like(self.params[n])) for n in self.groups}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = torch.clamp(s["clip_value"] / norm, max=1.0)
        lr = self.lr()
        b1, b2, eps = s["betas"][0], s["betas"][1], s["eps"]
        self.t += 1
        clipped = {}
        for n, g in grads.items():
            g = g * scale
            clipped[n] = g
            mult, wd = self.groups[n]
            m, v, p = self.m[n], self.v[n], self.params[n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = m / (1 - b1 ** self.t)
            vhat = v / (1 - b2 ** self.t)
            p.mul_(1 - lr * mult * wd)
            p.sub_(lr * mult * mhat / (vhat.sqrt() + eps))
        return clipped


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[n].double().norm() for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def train_readings(model: nn.Module, batches: Sequence[Dict], draws: Sequence,
                   crit_spec: Dict, opt_spec: Dict, dropout_seed: int,
                   initial: Dict[str, torch.Tensor]) -> Dict:
    """Three training steps of the reference from `initial` weights: each
    step's total loss, the first step's named losses, its clipped gradient
    norm per parameter, and the norm of each parameter's change after the
    three steps."""
    model.train()
    crit, wd = Criterion(crit_spec), weight_dict(crit_spec)
    opt = AdamW(model, opt_spec)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    losses, first = [], None
    for batch, d in zip(batches, draws):
        B, T = batch["images"].shape[:2]
        out = model(batch["images"], batch["audio_log_mel"], batch["pre_masks"], gen)
        K = batch["labels"].shape[2]
        named = crit(out, batch["labels"].reshape(B * T, K),
                     batch["masks"].reshape(B * T, K, *batch["masks"].shape[3:]).float(),
                     batch["valid"].reshape(B * T, K),
                     batch["gt_temporal_mask"].reshape(-1).float(), d)
        loss = sum(named[k] * wd[k] for k in named)
        for p in model.parameters():
            p.grad = None
        loss.backward()
        losses.append(float(loss.detach()))
        g = opt.step()
        if first is None:
            first = leaf_norms(g)
            terms = {k: float(v.detach()) for k, v in named.items()}
        del out, named, loss, g
    state = model.state_dict()
    change = leaf_norms({n: state[n] - initial[n] for n in first})
    return {"losses": losses, "terms": terms, "grad": first, "change": change}
