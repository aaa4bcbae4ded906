"""Bilinear grid and point sampling with `F.grid_sample` semantics, NHWC.

Port of `combo_avs_tpu/ops/grid_sample.py`: bilinear sampling with zero
padding outside the image and `align_corners=False`, in the JAX package's
channels-last layout (`feat [N, H, W, C]`, points `[N, P, 2]` as (x, y) in
[0, 1]). `point_sample_plain` is the plain PyTorch version; `point_sample` is
the device dispatch the criterion and the matcher call: a CUDA tensor goes to
the hand-written kernels of `ops.point_sample_cuda` (which raise on a shape
they cannot take), a CPU tensor to the plain version.
"""

from __future__ import annotations

import torch

from combo_avs_torch.ops.point_sample_cuda import point_sample_cuda


def bilinear_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `img` [N, H, W, C] at pixel coordinates x, y [N, P]
    with zero padding outside the image; returns [N, P, C]. The corner split
    is floor-based, so autograd gives grid_sample's corner gradients."""
    N, H, W, C = img.shape
    flat = img.reshape(N, H * W, C)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x0i = x0.long()
    y0i = y0.long()

    def corner(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return v * (w * valid)[..., None]

    return (corner(x0i, y0i, (1 - wx1) * (1 - wy1))
            + corner(x0i + 1, y0i, wx1 * (1 - wy1))
            + corner(x0i, y0i + 1, (1 - wx1) * wy1)
            + corner(x0i + 1, y0i + 1, wx1 * wy1))


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """`F.grid_sample(img, grid, "bilinear", "zeros", align_corners=False)`
    in NHWC: img [N, H, W, C], grid [N, Hg, Wg, 2] as (x, y) in [-1, 1] ->
    [N, Hg, Wg, C]."""
    N, H, W, C = img.shape
    _, Hg, Wg, _ = grid.shape
    gx = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    gy = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    out = bilinear_gather(img, gx.reshape(N, Hg * Wg), gy.reshape(N, Hg * Wg))
    return out.reshape(N, Hg, Wg, C)


def point_sample_plain(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """feat [N, H, W, C] at points [N, P, 2] in [0, 1] -> [N, P, C]: the
    pixel coordinates are `p * (W, H) - 0.5`, as the CUDA kernel computes
    them."""
    N, H, W, C = feat.shape
    return bilinear_gather(feat, points[..., 0] * W - 0.5, points[..., 1] * H - 0.5)


def point_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Device dispatch: the CUDA kernels for a CUDA `feat` (differentiable
    through `ops.point_sample_cuda.PointSampleFunction`), the plain version
    for a CPU one."""
    if feat.is_cuda:
        return point_sample_cuda(feat, points)
    return point_sample_plain(feat, points)
