"""The eval step: batch of raw frames -> per-frame semantic probability maps.

Port of the eval half of `combo_avs_tpu/train/train_step.py`
(`make_eval_step`, `_model_inputs`). PyTorch runs eagerly, so there is no
jit; the step runs under `torch.inference_mode()`.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from combo_avs_torch.models.meta_arch import semantic_inference


def _model_inputs(batch: Dict, dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(images, audio_log_mel, pre_masks) moved to `device` and cast to the
    compute type there (the loader ships uint8 frames and Maskiges, which
    bf16 holds exactly)."""

    def cast(x):
        x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        return x.to(device=device, non_blocking=True).to(dtype)

    return cast(batch["images"]), cast(batch["audio_log_mel"]), cast(batch["pre_masks"])


def _tensors(module: torch.nn.Module):
    return [*module.parameters(), *module.buffers()]


def make_eval_step(model: torch.nn.Module, out_size: Tuple[int, int],
                   bf16: bool = False) -> Callable[[Dict], torch.Tensor]:
    """Returns `step(batch) -> [B*T, C, H, W]` float32 semantic maps at
    `out_size`.

    bf16=True runs the whole forward in bfloat16: parameters, frozen buffers
    and inputs (the deformable-attention kernel still accumulates in fp32).
    The step keeps a bf16 copy of the weights and refreshes it before a call
    whenever a parameter or buffer of `model` changed since the last one (a
    `load_state_dict`, an optimizer step), so like the fp32 step it always
    runs the model's current weights. With bf16=False the forward runs in the
    weights' own type."""
    model.eval()
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
        with torch.inference_mode():
            outputs = net(*_model_inputs(batch, dtype, device))
            return semantic_inference(outputs["pred_logits"], outputs["pred_masks"],
                                      out_size=out_size)

    return eval_step
