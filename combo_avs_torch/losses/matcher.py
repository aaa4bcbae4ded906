"""Hungarian matcher with static shapes.

Port of `combo_avs_tpu/losses/matcher.py`. Per frame, the cost of matching
query q to target slot k is

  C = cost_class * (-softmax(logits)[q, label_k])
    + cost_mask  * mean sigmoid-CE(point-sampled mask q, target mask k)
    + cost_dice  * dice(point-sampled mask q, target mask k)

on one shared set of uniform random points per frame. Targets are padded to
K slots; an invalid slot costs `BIG_COST` against every query, and its
assignment comes back as -1. The assignment is solved on the device
(`ops.lsap`). Everything runs under `torch.no_grad()`: matching carries no
gradient.

On the card a call that `ops.match_cost_cuda.kernel_takes` (at most MAX_K
slots, maps a block can stage) computes the cost in one hand-written kernel;
every other call, and every CPU call, runs the plain composition
`cost_matrix` (then `nan_to_num`), which is also the kernel's oracle.
"""

from __future__ import annotations

import torch

from combo_avs_torch.ops import match_cost_cuda
from combo_avs_torch.ops.grid_sample import point_sample
from combo_avs_torch.ops.lsap import solve_lsap_batch
from combo_avs_torch.utils import profiling

# Padding cost for invalid target slots: above any real cost (at most about
# 12 = 2 CE + 5 BCE + 5 dice), small enough for float32 sums to resolve real
# cost gaps (the JAX package's value)
BIG_COST = 1e4


def _targets_nhwc(tgt_masks: torch.Tensor) -> torch.Tensor:
    """[N, K, H, W] bool or float target masks -> [N, H, W, K] float32 (float64
    stays float64), in one copy: the layout the point sampler reads."""
    N, K, H, W = tgt_masks.shape
    dtype = torch.promote_types(tgt_masks.dtype, torch.float32)
    out = torch.empty((N, H, W, K), dtype=dtype, device=tgt_masks.device)
    return out.copy_(tgt_masks.permute(0, 2, 3, 1))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) with no cut-off (F.softplus returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def batch_sigmoid_ce_cost(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[n, Q, P] logits x [n, K, P] binary targets -> [n, Q, K] mean-BCE cost."""
    P = logits.shape[-1]
    pos = _softplus(-logits)  # BCE against target 1
    neg = _softplus(logits)  # BCE against target 0
    t = targets.transpose(-1, -2)
    return (pos @ t + neg @ (1.0 - t)) / P


def batch_dice_cost(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[n, Q, P] logits x [n, K, P] binary targets -> [n, Q, K] dice cost."""
    p = logits.sigmoid()
    numerator = 2.0 * (p @ targets.transpose(-1, -2))
    denominator = p.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


class HungarianMatcher:
    def __init__(self, cost_class: float = 2.0, cost_mask: float = 5.0,
                 cost_dice: float = 5.0, num_points: int = 12544):
        # S4 defaults: CLASS/MASK/DICE_WEIGHT and TRAIN_NUM_POINTS of
        # combo_avs_tpu/configs/avs_s4/COMBO_R50_bs8_90k.yaml:52-54,66
        self.cost_class = cost_class
        self.cost_mask = cost_mask
        self.cost_dice = cost_dice
        self.num_points = num_points

    @torch.no_grad()
    def cost_matrix(self, points, pred_logits, pred_masks, tgt_labels, tgt_masks, tgt_valid):
        """points [N, num_points, 2] in [0, 1] (one set per frame),
        pred_logits [N, Q, C+1], pred_masks [N, Q, h, w], tgt_labels [N, K],
        tgt_masks [N, K, H, W] (bool or float), tgt_valid [N, K] -> [N, Q, K].
        Each frame's Q predicted masks (and K target masks) ride the channel
        axis of one point-sampling call."""
        out_prob = pred_logits.softmax(-1)  # [N, Q, C+1]
        cost_class = -torch.gather(
            out_prob, 2, tgt_labels[:, None, :].long().expand(-1, out_prob.shape[1], -1))
        out_pts = point_sample(pred_masks.permute(0, 2, 3, 1).contiguous(), points)
        out_pts = out_pts.transpose(1, 2)  # [N, Q, P]
        # the loader's bool masks become float32 (float64 stays float64)
        tgt_pts = point_sample(_targets_nhwc(tgt_masks), points)
        tgt_pts = tgt_pts.transpose(1, 2).to(out_pts.dtype)  # [N, K, P]
        C = (self.cost_class * cost_class
             + self.cost_mask * batch_sigmoid_ce_cost(out_pts, tgt_pts)
             + self.cost_dice * batch_dice_cost(out_pts, tgt_pts))
        return torch.where(tgt_valid[:, None, :], C, torch.full_like(C, BIG_COST))

    @torch.no_grad()
    def __call__(self, points, pred_logits, pred_masks, tgt_labels, tgt_masks, tgt_valid):
        """Returns the assignment [N, K] int64: the query matched to each
        target slot, -1 for an invalid slot."""
        return self.match_layers([(points, pred_logits, pred_masks, tgt_labels, tgt_masks,
                                   tgt_valid)])[0]

    @torch.no_grad()
    def solved_costs(self, layers):
        """The [N, Q, K] cost matrix `match_layers` solves for each argument
        tuple of `__call__` in `layers`: the kernel's where `kernel_takes`
        the call, else `cost_matrix` with its nans and infinities replaced.
        The kernel's calls share one float32 copy of target masks they share
        (the decoder outputs are matched to the same targets)."""
        costs, nhwc = [], (None, None)  # (target masks, their [N, H, W, K] copy)
        for points, logits, masks, labels, tgt_masks, valid in layers:
            if match_cost_cuda.kernel_takes(masks.device.type, masks.shape[-2:], labels.shape[-1]):
                if nhwc[0] is not tgt_masks:
                    nhwc = tgt_masks, _targets_nhwc(tgt_masks)
                costs.append(match_cost_cuda.match_cost_cuda(
                    points, logits, masks, point_sample(nhwc[1], points), labels, valid,
                    (self.cost_class, self.cost_mask, self.cost_dice)))
            else:
                costs.append(torch.nan_to_num(
                    self.cost_matrix(points, logits, masks, labels, tgt_masks, valid),
                    nan=BIG_COST, posinf=BIG_COST, neginf=-BIG_COST))
        return costs

    @torch.no_grad()
    def match_layers(self, layers):
        """`__call__` for several decoder outputs at once: `layers` holds one
        argument tuple of `__call__` each, and the list of their assignments
        comes back. Every output's cost matrices go to the solver in one
        batch (the Jonker-Volgenant solver's fixed trip count then runs once
        a step, not once an output); each matrix is solved on its own, so
        the assignments are those of separate calls."""
        with profiling.span("combo.criterion.match_cost"):
            costs = self.solved_costs(layers)
        with profiling.span("combo.criterion.lsap"):
            # rows = target slots, columns = queries (K <= Q)
            assign = solve_lsap_batch(torch.cat(costs).transpose(1, 2))
        valid = [args[5] for args in layers]
        return [torch.where(ok, a, torch.full_like(a, -1))
                for ok, a in zip(valid, assign.split([c.shape[0] for c in costs]))]
