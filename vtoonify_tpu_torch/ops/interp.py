"""Resize and pooling ops with torch semantics, NCHW (port of
vtoonify_tpu/ops/interp.py, which re-implemented exactly these torch
functions as gathers).

* bilinear: half-pixel source coordinates clamped at 0
  (`align_corners=False`), or corner-aligned — `F.interpolate`'s own rules.
* nearest: source index floor(i * h / oh) — torch 'nearest', NOT
  'nearest-exact'.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, size, align_corners: bool = False):
    """F.interpolate(mode='bilinear'); identity when the size is unchanged."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x, size):
    return F.interpolate(x, size=tuple(size), mode="nearest")


def grid_sample(x, grid, align_corners: bool = False, padding_mode: str = "zeros"):
    """F.grid_sample(mode='bilinear'); grid (N, Ho, Wo, 2) normalized (x, y).
    The plain version of kernel B5 (`ops.kernels.affine_warp`) is this call
    on an affine's grid."""
    return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding_mode,
                         align_corners=align_corners)


def avg_pool(x, window, stride=None, padding=0):
    """F.avg_pool2d (zero padding counted, as the JAX reduce_window sum)."""
    return F.avg_pool2d(x, window, stride=stride, padding=padding)


def max_pool(x, window, stride=None, padding=0):
    return F.max_pool2d(x, window, stride=stride, padding=padding)


def adaptive_avg_pool(x, output_size=1):
    """AdaptiveAvgPool2d for the sizes the model zoo uses: 1x1 (global mean)
    or any size that evenly divides the input."""
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    h, w = x.shape[2:]
    if h % oh or w % ow:
        raise ValueError(f"adaptive_avg_pool: {h}x{w} not divisible by {oh}x{ow}")
    return F.adaptive_avg_pool2d(x, (oh, ow))
