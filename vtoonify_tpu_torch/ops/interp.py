"""Resize and pooling ops with torch semantics, NCHW (port of
vtoonify_tpu/ops/interp.py, which re-implemented exactly these torch
functions as gathers).

* bilinear: half-pixel source coordinates clamped at 0
  (`align_corners=False`), or corner-aligned — `F.interpolate`'s own rules.
* nearest: source index floor(i * h / oh) — torch 'nearest', NOT
  'nearest-exact'.

On a row-sharded activation (`parallel.spatial`) the resizes, `max_pool` and
`adaptive_avg_pool(x, 1)` read their source rows from whichever slabs hold
them, clamped and padded only at the frame's edges, and the global pool sums
over the slabs. Each computes its rows the way torch does: the resizes
interpolate the width with `F.interpolate`, then combine the source rows
with torch's source coordinates and weights, in float32 (float64 for a
float64 input).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vtoonify_tpu_torch.parallel import spatial


def _opmath(dtype):
    """torch's interpolation arithmetic: float64 for float64, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _source_rows(mode, h_in, h_out, align_corners, o0, o1, dtype, device):
    """torch's source rows of output rows [o0, o1), made on `device` (no
    host-to-device copy, which would wait on the stream): bilinear
    (area_pixel_compute_source_index) the upper row i0, the lower row i1 and
    i1's weight, in the opmath dtype; nearest (nearest_idx) the row, twice,
    and no weight."""
    if mode == "nearest":
        o = torch.arange(o0, o1, device=device)
        if h_out == h_in:
            i = o
        elif h_out == 2 * h_in:
            i = o >> 1
        else:
            scale = float(np.float32(h_in) / np.float32(h_out))
            i = torch.floor(o.float() * scale).long().clamp(max=h_in - 1)
        return i, i, None
    ft = _opmath(dtype)
    nt = np.float64 if ft == torch.float64 else np.float32
    o = torch.arange(o0, o1, device=device, dtype=ft)
    if align_corners:
        src = o * (float(nt(h_in - 1) / nt(h_out - 1)) if h_out > 1 else 0.0)
    else:
        src = ((o + 0.5) * float(nt(h_in) / nt(h_out)) - 0.5).clamp(min=0)
    i0 = src.long()
    return i0, i0 + (i0 < h_in - 1), src - i0.to(ft)


def _resize_rows(x, size, mode, align_corners=None):
    """resize_bilinear / resize_nearest on row slabs (NCHW)."""
    (h_out, w_out), h_in = size, x.height
    if x.axis != 2:
        raise ValueError("a row-sharded resize takes NCHW slabs")

    def source(o0, o1, device):
        return _source_rows(mode, h_in, h_out, align_corners, o0, o1, x.dtype, device)

    def window(o0, o1):
        i0, i1, _ = source(o0, o1, "cpu")
        return int(i0[0]), int(i1[-1]) + 1

    def fn(t, o0, o1, a):
        i0, i1, lam = source(o0, o1, t.device)
        if mode == "nearest":
            t = t.index_select(2, i0 - a)
            if w_out != t.shape[3]:
                t = F.interpolate(t, size=(t.shape[2], w_out), mode="nearest")
            return t
        acc = t.to(_opmath(t.dtype))
        if w_out != t.shape[3]:  # the width; the rows are the identity here
            acc = F.interpolate(acc, size=(t.shape[2], w_out), mode="bilinear",
                                align_corners=align_corners)
        l1 = lam[:, None]
        out = (1 - l1) * acc.index_select(2, i0 - a) + l1 * acc.index_select(2, i1 - a)
        return out.to(t.dtype)

    return spatial.map_windows(x, fn, h_out, window)


def resize_bilinear(x, size, align_corners: bool = False):
    """F.interpolate(mode='bilinear'); identity when the size is unchanged."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    if isinstance(x, spatial.RowSharded):
        return _resize_rows(x, tuple(size), "bilinear", align_corners)
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x, size):
    if isinstance(x, spatial.RowSharded):
        return _resize_rows(x, tuple(size), "nearest")
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
    if isinstance(x, spatial.RowSharded):
        k, s, p = (spatial._pair(v)[0] for v in (window, window if stride is None else stride,
                                                 padding))
        return spatial.strided_window(
            lambda t: F.max_pool2d(t, window, stride=stride, padding=padding), x, k, s, p)
    return F.max_pool2d(x, window, stride=stride, padding=padding)


def adaptive_avg_pool(x, output_size=1):
    """AdaptiveAvgPool2d for the sizes the model zoo uses: 1x1 (global mean)
    or any size that evenly divides the input."""
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    h, w = x.shape[2:]
    if isinstance(x, spatial.RowSharded):
        if (oh, ow) != (1, 1):
            raise ValueError("adaptive_avg_pool on row slabs: output size 1 only")
        acc = torch.promote_types(x.dtype, torch.float32)
        total = spatial.all_reduce_sum([t.to(acc).sum((2, 3), keepdim=True)
                                        for t in x.parts])
        return (total / (h * w)).to(x.dtype)
    if h % oh or w % ow:
        raise ValueError(f"adaptive_avg_pool: {h}x{w} not divisible by {oh}x{ow}")
    return F.adaptive_avg_pool2d(x, (oh, ow))
