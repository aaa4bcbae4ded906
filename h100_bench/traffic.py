"""The one traffic generator: batches made on the device from the seed.

A cell's workload file gives the parameters (`traffic`): videos a step,
frames a video, frame size, target slots and how many of them hold an
object, which frames carry ground truth, and how many distinct batches
the window cycles through. A batch is what the program's loader ships:
uint8 frames and Maskiges [B, T, H, W, 3], a float32 log-mel [B, T, 96,
64]; for training also int labels [B, T, K], bool masks [B, T, K, H, W]
(one ellipse per slot), bool `valid` [B, T, K] and the per-frame weight
`gt_temporal_mask` [B, T]. The criterion's random draws for each batch
come from the same seed (`draws`), so both the program and the reference
take the same points.
"""

from __future__ import annotations

from typing import Dict, List

import torch

LOG_MEL = (96, 64)


def batch(t: Dict, train: bool, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    B, T, S = t["videos"], t["frames"], t["size"]
    u8 = dict(generator=g, device=device, dtype=torch.uint8)
    out = {
        "images": torch.randint(0, 256, (B, T, S, S, 3), **u8),
        "audio_log_mel": torch.randn((B, T, *LOG_MEL), generator=g, device=device),
        "pre_masks": torch.randint(0, 256, (B, T, S, S, 3), **u8),
    }
    if not train:
        return out
    K = t["slots"]
    # one ellipse per slot: centre in the middle 80%, radii 10-40% of the side
    c = 0.1 + 0.8 * torch.rand((B, T, K, 2), generator=g, device=device)
    r = 0.1 + 0.3 * torch.rand((B, T, K, 2), generator=g, device=device)
    axis = (torch.arange(S, device=device, dtype=torch.float32) + 0.5) / S
    dy = (axis[:, None] - c[..., 1, None, None]) / r[..., 1, None, None]
    dx = (axis[None, :] - c[..., 0, None, None]) / r[..., 0, None, None]
    valid = torch.zeros((B, T, K), dtype=torch.bool, device=device)
    valid[..., :t["objects"]] = True
    weight = torch.zeros((B, T), device=device)
    if t["annotated"] == "first":
        weight[:, 0] = 1.0
    elif t["annotated"] == "all":
        weight[:] = 1.0
    else:
        raise ValueError(f"annotated: 'first' or 'all', not {t['annotated']!r}")
    out.update({
        "labels": torch.randint(0, t["classes"], (B, T, K), generator=g, device=device),
        "masks": dx * dx + dy * dy <= 1.0,
        "valid": valid,
        "gt_temporal_mask": weight,
    })
    return out


def pool(t: Dict, train: bool, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`t["pool"]` distinct batches for `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [batch(t, train, g, device) for _ in range(t["pool"])]


def draws(crit: Dict, t: Dict, seed: int, step: int, device) -> List[tuple]:
    """The criterion's draws for the `step`-th checked step, one triple per
    decoder output: (matcher points [N, P_m, 2], candidates [N*K, 3P, 2],
    random tail [N*K, P - 3P/4, 2]), uniform in [0, 1), N = videos x
    frames; made anew from the seed wherever they are needed."""
    g = torch.Generator(device=device).manual_seed(seed + step)
    N, K, P = t["videos"] * t["frames"], t["slots"], crit["num_points"]
    n_sampled = int(P * crit["oversample_ratio"])
    n_random = P - int(P * crit["importance_sample_ratio"])
    shapes = ((N, crit["matcher_points"], 2), (N * K, n_sampled, 2), (N * K, n_random, 2))
    return [tuple(torch.rand(s, generator=g, device=device) for s in shapes)
            for _ in range(crit["dec_layers"])]
