"""The train and eval steps.

Port of `combo_avs_tpu/train/train_step.py` (`make_train_step`,
`make_eval_step`, `_flatten_targets`, `_model_inputs`; `_cast_tree` and
the AMP step's output cast as `amp_forward`). PyTorch runs eagerly, so
there is no jit: the train step is forward, criterion, backward and
optimizer update in one call; the eval step runs under
`torch.inference_mode()`. Each step sets the model's mode for its call and
restores the mode it found.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from combo_avs_torch.losses.criterion import Draws, SetCriterion, total_loss
from combo_avs_torch.models.meta_arch import semantic_inference
from combo_avs_torch.train.optim import Optimizer


def _model_inputs(batch: Dict, dtype: torch.dtype,
                  device: torch.device) -> Tuple[Optional[torch.Tensor], ...]:
    """(images, audio_log_mel, pre_masks, vid_temporal_mask) moved to
    `device` and cast to the compute type there (the loader ships uint8
    frames and Maskiges, which bf16 holds exactly); the flag is None when
    the batch has none."""
    vid = batch.get("vid_temporal_mask")
    return (*(_to(batch[k], device, dtype) for k in ("images", "audio_log_mel", "pre_masks")),
            None if vid is None else _to(vid, device, dtype))


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
                   amp: bool = False) -> Dict[str, torch.Tensor]:
    """The training forward: model outputs on the batch, then every named
    loss. `gt_temporal_mask` [B, T] becomes the per-frame weight (S4: the
    first frame of each video); `vid_temporal_mask` [B, T], when the batch
    has one, gates each frame's audio feature. Dropout (in training mode) and the
    criterion's draws come from `generator`, in that order, unless `draws`
    are given. With `amp` the forward runs in bfloat16 (`amp_forward`) on
    inputs cast to bfloat16 on the device, and the losses in float32. The
    model's mode is the caller's."""
    param = next(model.parameters())
    if amp:
        outputs = amp_forward(model, _model_inputs(batch, torch.bfloat16, param.device),
                              generator)
    else:
        outputs = model(*_model_inputs(batch, param.dtype, param.device),
                        dropout_generator=generator)
    targets = _flatten_targets(batch, param.device)
    fw = batch.get("gt_temporal_mask")
    fw = None if fw is None else _to(fw, param.device, torch.float32).reshape(-1)
    return criterion(outputs, targets, frame_weight=fw, generator=generator, draws=draws)


def make_train_step(model: torch.nn.Module, criterion: SetCriterion,
                    weight_dict: Dict[str, float], optimizer: Optimizer,
                    generator: torch.Generator,
                    amp: bool = False) -> Callable[[Dict], Dict[str, torch.Tensor]]:
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
    float32. bf16 needs no loss scaling (float32's exponent range)."""

    def train_step(batch: Dict) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.train()
        try:
            losses = compute_losses(model, criterion, batch, generator, amp=amp)
            loss = total_loss(losses, weight_dict)
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
        finally:
            model.train(was_training)
        return {"total_loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}}

    return train_step


def _tensors(module: torch.nn.Module):
    return [*module.parameters(), *module.buffers()]


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
    net = copy.deepcopy(model).to(torch.bfloat16) if bf16 else model
    param = next(net.parameters())
    dtype, device = param.dtype, param.device

    def stamp():
        return [(t.data_ptr(), t._version) for t in _tensors(model)]

    synced = stamp()  # what the bf16 copy was taken from

    def eval_step(batch: Dict) -> torch.Tensor:
        if net is not model and stamp() != synced:
            with torch.no_grad():
                for dst, src in zip(_tensors(net), _tensors(model)):
                    dst.copy_(src)
            synced[:] = stamp()
        was_training = net.training
        net.eval()
        try:
            with torch.inference_mode():
                inputs = _model_inputs(batch, dtype, device)
                outputs = net(*inputs)
                vid = inputs[3]
                return semantic_inference(
                    outputs["pred_logits"], outputs["pred_masks"], out_size=out_size,
                    temporal_mask=None if vid is None else vid.reshape(-1))
        finally:
            net.train(was_training)

    return eval_step
