"""Set criterion: Hungarian-matched CE, PointRend mask and dice losses, and
the adaptive inter-frame cosine loss.

Port of `combo_avs_tpu/losses/criterion.py` with its static-shape design:
targets are padded to K slots per frame (`labels [N, K]`, `masks [N, K, H,
W]`, `valid [N, K]`), and the reference's frame selection (S4: the first
annotated frame only) is a per-frame weight `frame_weight [N]`; a frame of
weight 0 contributes to no matched loss.

The random draws (the matcher's shared points, the 3x oversampled candidate
points and the random tail of PointRend's selection) come from an explicit
`torch.Generator`, or are injected per layer, so that tests can feed both
this criterion and the JAX one the same numbers.

Data parallel (`parallel/distributed.py::World`, more than one rank): the
JAX package computes the loss on the global batch, so its normalizers are
global (combo_avs_tpu/losses/criterion.py:15-16,179,242,262). Here each
rank holds its rows of that batch, and the three normalizers (`num_masks`,
the class loss's weight sum, the cosine loss's video count) are summed over
the ranks in one small all-reduce of the rank's local values. Each rank's
losses are then its share of the global losses: the ranks' losses, and
their gradients, SUM to the global ones, with no division by the number of
ranks. The draws are made at the global batch's shape from the generator
every rank seeds alike, and each rank keeps its rows, so the points do not
depend on the number of ranks. With one rank no sum runs and the draws are
the batch's own.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from combo_avs_torch.losses.matcher import HungarianMatcher
from combo_avs_torch.ops.gather_cuda import gather_points, gather_points_plain
from combo_avs_torch.ops.grid_sample import point_sample
from combo_avs_torch.parallel import distributed

# Chunk width of the stratified uncertain-point selection (the JAX package's
# _STRAT_CHUNK): each chunk of candidates keeps a fixed quota of its most
# uncertain points, recall about 0.96 of the exact top-k
STRAT_CHUNK = 256

# (matcher points [N, MP, 2], candidates [N*K, 3P, 2], random tail [N*K, P - 3P/4, 2])
Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _upcast32(x: torch.Tensor) -> torch.Tensor:
    """bool, bf16 and fp16 to float32; float32 and float64 unchanged."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def stratified_chunk(n_sampled: int, n_uncertain: int) -> Optional[Tuple[int, int]]:
    """(chunk, quota) of the stratified selection, or None when the shapes
    do not divide."""
    ch = STRAT_CHUNK
    if n_sampled % ch == 0 and (n_uncertain * ch) % n_sampled == 0 \
            and n_uncertain * ch // n_sampled > 0:
        return ch, n_uncertain * ch // n_sampled
    return None


def stratified_uncertain_coords(logits: torch.Tensor, coords: torch.Tensor, ch: int,
                                quota: int) -> torch.Tensor:
    """logits [M, NS], coords [M, NS, 2] -> [M, NS / ch * quota, 2]: each
    `ch`-wide chunk of candidates sorted by |logit| (most uncertain first),
    its first `quota` kept."""
    M, NS = logits.shape
    nchunk = NS // ch
    order = torch.sort(logits.abs().reshape(M * nchunk, ch), dim=-1, stable=True).indices
    keep = order[:, :quota]
    xy = coords.reshape(M * nchunk, ch, 2)
    picked = torch.gather(xy, 1, keep[..., None].expand(-1, -1, 2))
    return picked.reshape(M, nchunk * quota, 2)


def uncertainty_sampled_points(mask_logits: torch.Tensor, candidates: torch.Tensor,
                               tail: torch.Tensor, num_points: int,
                               importance_sample_ratio: float,
                               exact_topk: bool = False) -> torch.Tensor:
    """PointRend point selection: of the candidate points [M, NS, 2], the
    `num_points * importance_sample_ratio` where |mask logit| is smallest,
    then the random `tail`; returns [M, num_points, 2], carrying no gradient.

    On a CUDA tensor with `exact_topk` False the selection is the JAX
    package's on an accelerator: the stratified one whenever the shapes
    divide, else the top-k followed by the gather kernel (K6). The JAX
    package takes `approx_max_k` there (recall target 0.95); `torch.topk` is
    exact, so it meets that target by construction. Otherwise, and always on
    the CPU, it is the exact top-k and `torch.gather`."""
    n_uncertain = int(num_points * importance_sample_ratio)
    with torch.no_grad():
        logits = point_sample(mask_logits[..., None], candidates)[..., 0]  # [M, NS]
        strat = stratified_chunk(candidates.shape[1], n_uncertain)
        if mask_logits.is_cuda and not exact_topk and strat:
            top = stratified_uncertain_coords(logits, candidates, *strat)
        else:
            idx = torch.topk(-logits.abs(), n_uncertain, dim=-1).indices
            top = (gather_points_plain if exact_topk else gather_points)(candidates, idx)
        return torch.cat([top, tail.to(top.dtype)], dim=1)


class SetCriterion:
    def __init__(
        self,
        num_classes: int = 2,
        matcher: Optional[HungarianMatcher] = None,
        eos_coef: float = 0.1,
        num_points: int = 12544,
        oversample_ratio: float = 3.0,
        importance_sample_ratio: float = 0.75,
        cosine_n_frame: int = 5,
        exact_topk: bool = False,
    ):
        # S4 defaults: NUM_CLASSES, NO_OBJECT_WEIGHT, TRAIN_NUM_POINTS,
        # OVERSAMPLE_RATIO, IMPORTANCE_SAMPLE_RATIO of
        # combo_avs_tpu/configs/avs_s4/COMBO_R50_bs8_90k.yaml:30,51,66-68;
        # cosine_n_frame 5 as combo_avs_tpu/train/trainer.py:99;
        # exact_topk = MODEL.MASK_FORMER.EXACT_TOPK_POINTS (config.py:354)
        self.num_classes = num_classes
        self.matcher = matcher if matcher is not None else HungarianMatcher()
        self.eos_coef = eos_coef
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.cosine_n_frame = cosine_n_frame
        self.exact_topk = exact_topk

    def draw(self, generator: torch.Generator, N: int, K: int) -> Draws:
        """One layer's random draws, uniform in [0, 1), float32, on the
        generator's device."""
        M = N * K
        n_sampled = int(self.num_points * self.oversample_ratio)
        n_random = self.num_points - int(self.num_points * self.importance_sample_ratio)
        shapes = ((N, self.matcher.num_points, 2), (M, n_sampled, 2), (M, n_random, 2))
        return tuple(torch.rand(s, generator=generator, device=generator.device)
                     for s in shapes)

    def draw_shard(self, generator: torch.Generator, N: int, K: int,
                   world: distributed.World) -> Draws:
        """A rank's rows of one layer's draws at the global batch's shape
        (`world.size` ranks of N frames each): the frames r*N .. (r+1)*N - 1
        and their masks."""
        pts, cand, tail = self.draw(generator, N * world.size, K)
        f, m = slice(world.rank * N, (world.rank + 1) * N), \
            slice(world.rank * N * K, (world.rank + 1) * N * K)
        return pts[f].clone(), cand[m].clone(), tail[m].clone()

    def class_weight_sum(self, valid: torch.Tensor, frame_weight: torch.Tensor,
                         num_queries: int) -> torch.Tensor:
        """The sum of the class loss's weights, in float64: each frame's
        weight times eos_coef for each of its queries left unmatched and 1
        for each matched one (one per valid slot). It does not depend on
        which queries the matching picks, so one value serves every decoder
        output."""
        n_valid = valid.sum(1).to(torch.float64)
        per_frame = self.eos_coef * (num_queries - n_valid) + n_valid
        return (frame_weight.to(torch.float64) * per_frame).sum()

    # ------------------------------------------------------------------
    def _loss_labels(self, pred_logits, labels, valid, assign, frame_weight, weight_sum=None):
        N, Q, _ = pred_logits.shape
        # an invalid slot writes to the extra column Q, which is then dropped
        safe_assign = torch.where(valid, assign, torch.full_like(assign, Q))
        target = torch.full((N, Q + 1), self.num_classes, dtype=torch.long,
                            device=pred_logits.device)
        target.scatter_(1, safe_assign, labels.long())
        target = target[:, :Q]
        logp = F.log_softmax(_upcast32(pred_logits), dim=-1)
        nll = -torch.gather(logp, 2, target[..., None])[..., 0]
        # no-object targets weigh eos_coef, in the loss's own float type
        empty = torch.ones_like(nll).masked_fill(target == self.num_classes, self.eos_coef)
        w = empty * frame_weight[:, None]
        total = w.sum() if weight_sum is None else weight_sum.to(w.dtype)
        return (nll * w).sum() / total.clamp(min=1e-6)

    # ------------------------------------------------------------------
    def _loss_masks(self, pred_masks, tgt_masks, valid, assign, num_masks, candidates, tail):
        N, Q, h, w = pred_masks.shape
        K = tgt_masks.shape[1]
        safe_assign = torch.where(valid, assign, torch.zeros_like(assign)).clamp(0, Q - 1)
        src = torch.gather(pred_masks, 1, safe_assign[:, :, None, None].expand(-1, -1, h, w))
        src_f = _upcast32(src.reshape(N * K, h, w))
        tgt_f = _upcast32(tgt_masks.reshape(N * K, *tgt_masks.shape[2:]))
        coords = uncertainty_sampled_points(src_f.detach(), candidates, tail, self.num_points,
                                            self.importance_sample_ratio, self.exact_topk)
        with torch.no_grad():
            point_labels = point_sample(tgt_f[..., None], coords)[..., 0]
        vmask = valid.reshape(N * K).to(torch.float32)

        point_logits = point_sample(src_f[..., None], coords)[..., 0]  # [NK, P]
        # sigmoid CE, mean over points, summed over valid masks
        ce = point_logits.clamp(min=0) - point_logits * point_labels \
            + torch.log1p(torch.exp(-point_logits.abs()))
        loss_mask = (ce.mean(-1) * vmask).sum() / num_masks
        p = point_logits.sigmoid()
        numerator = 2.0 * (p * point_labels).sum(-1)
        denominator = p.sum(-1) + point_labels.sum(-1)
        dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
        loss_dice = (dice * vmask).sum() / num_masks
        return loss_mask, loss_dice

    # ------------------------------------------------------------------
    def _loss_cosine(self, middle: torch.Tensor, n_videos=None) -> torch.Tensor:
        """middle [N, Q, HW]: adjacent-frame cosine distance d of each video's
        mask predictions, weighted by exp(-d), averaged over `n_videos`
        (default: this batch's)."""
        n_frame = self.cosine_n_frame
        bs = middle.shape[0] // n_frame
        m = _upcast32(middle.reshape(bs, n_frame, -1))
        total = torch.zeros((bs,), dtype=m.dtype, device=m.device)
        for f in range(n_frame - 1):
            a, b = m[:, f], m[:, f + 1]
            denom = (torch.linalg.vector_norm(a, dim=-1)
                     * torch.linalg.vector_norm(b, dim=-1)).clamp(min=1e-8)
            d = 1.0 - (a * b).sum(-1) / denom
            total = total + d * torch.exp(-d)
        bs = bs if n_videos is None else n_videos.to(total.dtype)
        return total.sum() / bs / (n_frame - 1)

    # ------------------------------------------------------------------
    def __call__(
        self,
        outputs: Dict[str, object],
        targets: Dict[str, torch.Tensor],
        frame_weight: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Sequence[Draws]] = None,
        world: Optional[distributed.World] = None,
    ) -> Dict[str, torch.Tensor]:
        """outputs: the model's output dict; targets: labels [N, K] int,
        masks [N, K, H, W], valid [N, K] bool; frame_weight [N] (None = all
        ones). The draws come from `generator` unless `draws` gives them, one
        (matcher points, candidates, tail) per layer: the final prediction
        first, then the aux layers in order; injected draws are this rank's
        rows. `world` (default: one rank) is the ranks whose batches make the
        global one; with more than one, the losses are this rank's shares of
        the global losses (the module docstring)."""
        world = world or distributed.World()
        labels, tgt_masks = targets["labels"], targets["masks"]
        N, K = labels.shape
        device = outputs["pred_logits"].device
        if frame_weight is None:
            frame_weight = torch.ones((N,), dtype=torch.float32, device=device)
        valid = targets["valid"] & (frame_weight[:, None] > 0)
        weight_sum = n_videos = None
        if world.size == 1:
            num_masks = valid.sum().to(torch.float32).clamp(min=1.0)
        else:
            Q = outputs["pred_logits"].shape[1]
            local = torch.stack([valid.sum().to(torch.float64),
                                 self.class_weight_sum(valid, frame_weight, Q),
                                 torch.tensor(float(N // self.cosine_n_frame),
                                              dtype=torch.float64, device=device)])
            total_masks, weight_sum, n_videos = world.all_sum_(local)
            num_masks = total_masks.to(torch.float32).clamp(min=1.0)

        layers = [(outputs["pred_logits"], outputs["pred_masks"], "")] + [
            (a["pred_logits"], a["pred_masks"], f"_{i}")
            for i, a in enumerate(outputs.get("aux_outputs", []))]
        if draws is None:
            if generator is None:
                raise ValueError("SetCriterion needs a generator or injected draws")
            draws = [self.draw_shard(generator, N, K, world) for _ in layers]
        if len(draws) != len(layers):
            raise ValueError(f"{len(draws)} draws for {len(layers)} layers")

        assigns = self.matcher.match_layers(
            [(pts, logits, masks, labels, tgt_masks, valid)
             for (logits, masks, _), (pts, _, _) in zip(layers, draws)])
        losses: Dict[str, torch.Tensor] = {}
        for (logits, masks, suffix), (_, candidates, tail), assign in zip(layers, draws, assigns):
            losses[f"loss_ce{suffix}"] = self._loss_labels(logits, labels, valid, assign,
                                                           frame_weight, weight_sum)
            lm, ld = self._loss_masks(masks, tgt_masks, valid, assign, num_masks,
                                      candidates, tail)
            losses[f"loss_mask{suffix}"] = lm
            losses[f"loss_dice{suffix}"] = ld

        for i, middle in enumerate(outputs.get("middles_attn_mask", [])):
            losses[f"loss_cosine_{i}"] = self._loss_cosine(middle, n_videos)
        return losses


def build_weight_dict(cfg=None, dec_layers: int = 10, class_weight: float = 2.0,
                      mask_weight: float = 5.0, dice_weight: float = 5.0,
                      cosine_weight: float = 10.0) -> Dict[str, float]:
    """Loss name -> weight, with a copy per aux layer (ref:
    maskformer_model.py:192-238). `dec_layers` is the config's DEC_LAYERS
    (the final prediction plus DEC_LAYERS - 1 aux ones). With a config the
    numbers are its MODEL.MASK_FORMER's, else the keywords' (S4 defaults:
    combo_avs_tpu/configs/avs_s4/COMBO_R50_bs8_90k.yaml:52-55,65)."""
    if cfg is not None:
        mf = cfg.MODEL.MASK_FORMER
        dec_layers, class_weight, mask_weight, dice_weight, cosine_weight = (
            mf.DEC_LAYERS, mf.CLASS_WEIGHT, mf.MASK_WEIGHT, mf.DICE_WEIGHT, mf.COSINE_WEIGHT)
    base = {"loss_ce": class_weight, "loss_mask": mask_weight, "loss_dice": dice_weight}
    out = dict(base)
    for i in range(dec_layers - 1):
        for k, v in base.items():
            out[f"{k}_{i}"] = v
    if cosine_weight > 0:
        for i in range(dec_layers - 1):
            out[f"loss_cosine_{i}"] = cosine_weight
    return out


def build_criterion(cfg) -> SetCriterion:
    """The criterion a config describes (combo_avs_tpu/train/trainer.py:
    84-101): matcher costs and point counts from MODEL.MASK_FORMER, the
    cosine loss over 5 frames as the reference always takes it (ref:
    criterion.py:282-286)."""
    mf = cfg.MODEL.MASK_FORMER
    matcher = HungarianMatcher(cost_class=mf.CLASS_WEIGHT, cost_mask=mf.MASK_WEIGHT,
                               cost_dice=mf.DICE_WEIGHT, num_points=mf.TRAIN_NUM_POINTS)
    return SetCriterion(num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, matcher=matcher,
                        eos_coef=mf.NO_OBJECT_WEIGHT, num_points=mf.TRAIN_NUM_POINTS,
                        oversample_ratio=mf.OVERSAMPLE_RATIO,
                        importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO, cosine_n_frame=5,
                        exact_topk=mf.get("EXACT_TOPK_POINTS", False))


def total_loss(losses: Dict[str, torch.Tensor], weight_dict: Dict[str, float]) -> torch.Tensor:
    unknown = set(losses) - set(weight_dict)
    if unknown:
        raise ValueError(f"losses without weights: {sorted(unknown)}")
    return sum(losses[k] * weight_dict[k] for k in losses)
