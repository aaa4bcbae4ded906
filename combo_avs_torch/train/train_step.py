"""The train and eval steps.

Port of `combo_avs_tpu/train/train_step.py` (`make_train_step`,
`make_eval_step`, `make_tta_eval_step`, `_flatten_targets`,
`_model_inputs`; `_cast_tree` and the AMP step's output cast as
`amp_forward`). PyTorch runs eagerly, so there is no jit: the train step is
forward, criterion, backward and optimizer update in one call; the eval
steps run under `torch.inference_mode()`. Each step sets the model's mode
for its call and restores the mode it found.

Data parallel (more than one rank in `parallel/distributed.py::World`):
each rank's losses are its share of the global batch's (the criterion's
global normalizers), so after the backward the ranks' gradients are SUMMED
(`all_sum_tensors_`, a few flat buckets) before the optimizer's clip: the
clip sees the global batch's gradient, as the JAX step's psum gives it. XLA's
psum is the model here rather than DistributedDataParallel, so the fp32 and
the bf16 AMP step (`torch.func.functional_call`) take the same path.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from combo_avs_torch.losses.criterion import Draws, SetCriterion, total_loss
from combo_avs_torch.models.meta_arch import semantic_inference
from combo_avs_torch.parallel import distributed
from combo_avs_torch.train.optim import Optimizer
from combo_avs_torch.utils import profiling


def _model_inputs(batch: Dict, dtype: torch.dtype,
                  device: torch.device) -> Tuple[Optional[torch.Tensor], ...]:
    """(images, audio_log_mel, pre_masks, vid_temporal_mask) moved to
    `device` and cast to the compute type there (the loader ships uint8
    frames and Maskiges, which bf16 holds exactly); the Maskiges and the
    flag are None when the batch has none."""
    return tuple(None if batch.get(k) is None else _to(batch[k], device, dtype)
                 for k in ("images", "audio_log_mel", "pre_masks", "vid_temporal_mask"))


def _to(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    x = x.to(device=device, non_blocking=True)
    return x if dtype is None else x.to(dtype)


def _flatten_targets(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """[B, T, ...] target arrays -> [B*T, ...] frame-major targets on `device`
    (masks keep the loader's bool type; the criterion casts them)."""
    labels = _to(batch["labels"], device, torch.long)
    B, T, K = labels.shape
    masks = _to(batch["masks"], device)
    return {
        "labels": labels.reshape(B * T, K),
        "masks": masks.reshape(B * T, K, *masks.shape[3:]),
        "valid": _to(batch["valid"], device, torch.bool).reshape(B * T, K),
    }


def _to_float32(tree):
    """The model's outputs with every bf16 tensor cast to float32."""
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_float32(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.float()
    return tree


def amp_forward(model: torch.nn.Module, inputs, generator: torch.Generator):
    """The AMP forward (combo_avs_tpu/train/train_step.py:98-124): every
    float32 parameter and buffer cast to bfloat16 (`_cast_tree`) and the
    model run on those copies, its outputs cast back to float32. The casts
    are differentiable, so gradients land on the float32 parameters. The
    whole network runs in bf16, as the JAX step's does; `torch.autocast`
    would keep LayerNorm, softmax and reductions in fp32 and so compute
    another function."""
    tensors = {name: t.to(torch.bfloat16) if t.dtype == torch.float32 else t
               for name, t in (*model.named_parameters(), *model.named_buffers())}
    outputs = functional_call(model, tensors, tuple(inputs),
                              {"dropout_generator": generator})
    return _to_float32(outputs)


def compute_losses(model: torch.nn.Module, criterion: SetCriterion, batch: Dict,
                   generator: torch.Generator, draws: Optional[Sequence[Draws]] = None,
                   amp: bool = False, dropout_generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """The training forward: model outputs on the batch, then every named
    loss. `gt_temporal_mask` [B, T] becomes the per-frame weight (S4: the
    first frame of each video); `vid_temporal_mask` [B, T], when the batch
    has one, gates each frame's audio feature. Dropout (in training mode) and the
    criterion's draws come from `generator`, in that order, unless `draws`
    are given; with `dropout_generator` dropout draws from it instead. With `amp` the forward runs in bfloat16 (`amp_forward`) on
    inputs cast to bfloat16 on the device, and the losses in float32. The
    model's mode is the caller's. A criterion with a world bound
    (`functools.partial(criterion, world=...)`, as `make_train_step` passes
    it) gives this rank's shares of the global losses."""
    param = next(model.parameters())
    dropout_generator = dropout_generator or generator
    with profiling.span("combo.forward"):
        if amp:
            outputs = amp_forward(model, _model_inputs(batch, torch.bfloat16, param.device),
                                  dropout_generator)
        else:
            outputs = model(*_model_inputs(batch, param.dtype, param.device),
                            dropout_generator=dropout_generator)
    targets = _flatten_targets(batch, param.device)
    fw = batch.get("gt_temporal_mask")
    fw = None if fw is None else _to(fw, param.device, torch.float32).reshape(-1)
    return criterion(outputs, targets, frame_weight=fw, generator=generator, draws=draws)


def make_train_step(model: torch.nn.Module, criterion: SetCriterion,
                    weight_dict: Dict[str, float], optimizer: Optimizer,
                    generator: torch.Generator, amp: bool = False,
                    dropout_generator: Optional[torch.Generator] = None,
                    world: Optional[distributed.World] = None
                    ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Returns `step(batch) -> metrics`: one training step (forward in
    training mode, losses, backward, clipped AdamW update) on a loader-format
    batch (uint8 `images` and `pre_masks` [B, T, H, W, 3], `audio_log_mel`,
    `labels` [B, T, K], bool `masks` [B, T, K, H, W], `valid` [B, T, K],
    `gt_temporal_mask` [B, T], optionally `vid_temporal_mask` [B, T]). The metrics are `total_loss` and every named
    loss, as 0-dim tensors on the model's device (reading them synchronizes).
    `generator` (on the model's device) drives dropout and the criterion's
    draws. amp=True is the AVSS regime (SOLVER.AMP.ENABLED): the forward in
    bfloat16 on bf16 copies of the float32 weights (`amp_forward`); the
    losses, the gradients on the float32 weights, the clip and AdamW in
    float32. bf16 needs no loss scaling (float32's exponent range).

    `world` (default: `distributed.current()`) with more than one rank: the
    batch is this rank's rows of the global batch, every rank seeds
    `generator` alike (the criterion draws at the global shape from it),
    dropout draws from `dropout_generator`, which must be the rank's own
    (e.g. seeded by `distributed.rank_seed`), the gradients are summed over
    the ranks before the clip, and the metrics are the global batch's
    losses. With one rank, dropout draws from `generator` unless
    `dropout_generator` is given."""
    world = world or distributed.current()
    if world.size > 1 and dropout_generator is None:
        raise ValueError("with more than one rank, dropout needs a generator of the rank's own "
                         "(dropout_generator)")
    params = optimizer.params
    ranked = functools.partial(criterion, world=world)
    # one process without a dropout generator calls compute_losses as it always has
    extra = {"dropout_generator": dropout_generator} if dropout_generator is not None else {}

    def train_step(batch: Dict) -> Dict[str, torch.Tensor]:
        with profiling.step_span("combo.step"):
            was_training = model.training
            model.train()
            try:
                losses = compute_losses(model, ranked, batch, generator, amp=amp, **extra)
                loss = total_loss(losses, weight_dict)
                optimizer.zero_grad()
                with profiling.span("combo.backward"):
                    loss.backward()
                metrics = {"total_loss": loss.detach(),
                           **{k: v.detach() for k, v in losses.items()}}
                if world.size > 1:
                    distributed.all_sum_tensors_([p.grad for p in params if p.grad is not None],
                                                 world)
                    summed = world.all_sum_(torch.stack(list(metrics.values())))
                    metrics = dict(zip(metrics, summed.unbind()))
                optimizer.step()
            finally:
                model.train(was_training)
            return metrics

    return train_step


def _tensors(module: torch.nn.Module):
    return [*module.parameters(), *module.buffers()]


class _EvalNet:
    """The network an eval step runs: `model` itself, or with bf16 a
    bfloat16 copy that `sync()` refreshes whenever a parameter or buffer of
    `model` changed since the last call (a `load_state_dict`, an optimizer
    step), so that the step always runs the model's current weights."""

    def __init__(self, model: torch.nn.Module, bf16: bool):
        self.model = model
        self.net = copy.deepcopy(model).to(torch.bfloat16) if bf16 else model
        param = next(self.net.parameters())
        self.dtype, self.device = param.dtype, param.device
        self._synced = self._stamp()  # what the bf16 copy was taken from

    def _stamp(self):
        return [(t.data_ptr(), t._version) for t in _tensors(self.model)]

    def sync(self) -> None:
        if self.net is not self.model and self._stamp() != self._synced:
            with torch.no_grad():
                for dst, src in zip(_tensors(self.net), _tensors(self.model)):
                    dst.copy_(src)
            self._synced = self._stamp()

    def run(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """fn() with the network in eval mode under inference_mode, after a
        sync; the mode it found is restored."""
        self.sync()
        was_training = self.net.training
        self.net.eval()
        try:
            with torch.inference_mode():
                return fn()
        finally:
            self.net.train(was_training)


def make_eval_step(model: torch.nn.Module, out_size: Tuple[int, int],
                   bf16: bool = False) -> Callable[[Dict], torch.Tensor]:
    """Returns `step(batch) -> [B*T, C, H, W]` float32 semantic maps at
    `out_size`. The batch's `vid_temporal_mask` [B, T], when it has one,
    gates each frame's audio feature in the model and weights its map.

    bf16=True runs the whole forward in bfloat16: parameters, frozen buffers
    and inputs (the deformable-attention kernel still accumulates in fp32).
    The step keeps a bf16 copy of the weights and refreshes it before a call
    whenever a parameter or buffer of `model` changed since the last one (a
    `load_state_dict`, an optimizer step), so like the fp32 step it always
    runs the model's current weights. With bf16=False the forward runs in the
    weights' own type. Each call runs the network in eval mode (no dropout)
    and then restores the mode it found."""
    ev = _EvalNet(model, bf16)

    def eval_step(batch: Dict) -> torch.Tensor:
        def forward():
            inputs = _model_inputs(batch, ev.dtype, ev.device)
            outputs = ev.net(*inputs)
            vid = inputs[3]
            return semantic_inference(
                outputs["pred_logits"], outputs["pred_masks"], out_size=out_size,
                temporal_mask=None if vid is None else vid.reshape(-1))

        return ev.run(forward)

    return eval_step


def resize_weights(n_in: int, n_out: int, dtype=np.float32) -> np.ndarray:
    """[n_in, n_out] weights of `jax.image.resize(..., "bilinear")` along one
    axis, in `dtype` arithmetic as XLA computes them there
    (jax/_src/image/scale.py::compute_weight_mat, antialias on, translation
    0): the triangle kernel at each output pixel's centre, widened by the
    scale when shrinking, normalised per output pixel. XLA contracts the
    sample position (i + 0.5) * inv_scale - 0.5 into one fused multiply-add,
    rounded once, and so does this (through long double)."""
    f = np.dtype(dtype).type
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f(max(inv_scale, 1.0))
    centre = (np.arange(n_out, dtype=dtype) + f(0.5)).astype(np.longdouble)
    sample = (centre * np.longdouble(f(inv_scale)) - np.longdouble(0.5)).astype(dtype)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=dtype)[:, None]) / kernel_scale
    w = np.maximum(f(0), f(1) - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f(1)), f(0))
    return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, f(0))


def resize_frames(x: torch.Tensor, size: int) -> torch.Tensor:
    """x [B, T, H, W, C] -> [B, T, size, size, C] as `jax.image.resize(x,
    (B, T, size, size, C), "bilinear")` computes it: one weight matrix per
    resized axis (an axis already at `size` is left alone), made in float32
    arithmetic (float64 for a float64 x, as JAX with x64) and cast to x's
    type, contracted in x's type. `F.interpolate(antialias=True)` places the
    same window but computes its weights otherwise (its float32 frames 4.8e-3
    from JAX's at 224 -> 384) and takes no bfloat16 on the CPU."""
    wtype = np.float64 if x.dtype == torch.float64 else np.float32
    for axis in (2, 3):
        n = x.shape[axis]
        if n == size:
            continue
        w = torch.from_numpy(resize_weights(n, size, wtype)).to(device=x.device, dtype=x.dtype)
        x = torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)
    return x


def make_tta_eval_step(model: torch.nn.Module, scales: Sequence[int], flip: bool,
                       out_size: Tuple[int, int],
                       bf16: bool = False) -> Callable[[Dict], torch.Tensor]:
    """Multi-scale and horizontal-flip test-time augmentation
    (combo_avs_tpu/train/train_step.py:144-195; the reference's
    TEST.AUG.{MIN_SIZES,FLIP}). Returns `step(batch) -> [B*T, C, H, W]`:
    for each scale (divisible by 32, the backbone's stride) and, with
    `flip`, each of the unflipped and the flipped frames, the forward on the
    frames and Maskiges resized to the scale (`resize_frames`, after the
    cast to the compute type) and flipped on W, its semantic maps at
    `out_size` (flipped back), and the mean of all of them. bf16 as in
    `make_eval_step`."""
    scales = [int(s) for s in scales]
    for s in scales:
        if s % 32:
            raise ValueError(f"TEST.AUG.MIN_SIZES entries must be divisible by 32 (the backbone "
                             f"stride), got {s} in {scales}")
    if not scales:
        raise ValueError("TEST.AUG.MIN_SIZES is empty")
    ev = _EvalNet(model, bf16)

    def eval_step(batch: Dict) -> torch.Tensor:
        def forward():
            images0, mel, pre0, vid = _model_inputs(batch, ev.dtype, ev.device)
            vt = None if vid is None else vid.reshape(-1)
            acc, n = None, 0
            for s in scales:
                for do_flip in ((False, True) if flip else (False,)):
                    imgs = resize_frames(images0, s)
                    pre = None if pre0 is None else resize_frames(pre0, s)
                    if do_flip:
                        imgs = imgs.flip(3)
                        pre = None if pre is None else pre.flip(3)
                    outputs = ev.net(imgs, mel, pre, vid)
                    sem = semantic_inference(outputs["pred_logits"], outputs["pred_masks"],
                                             out_size=out_size, temporal_mask=vt)
                    if do_flip:
                        sem = sem.flip(-1)
                    acc = sem if acc is None else acc + sem
                    n += 1
            return acc / n

        return ev.run(forward)

    return eval_step
