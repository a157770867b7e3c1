"""upfirdn2d — upsample -> FIR filter -> downsample, per channel (NCHW).

Port of vtoonify_tpu/ops/upfirdn2d.py. Semantics (reference
model/stylegan/op_cpu/upfirdn2d.py):

    1. zero-stuff each pixel with (up-1) zeros after it
    2. pad with (pad0, pad1) per axis; NEGATIVE pads crop
    3. true 2-D convolution with `kernel`
    4. keep every `down`-th sample

    out = (in * up + pad0 + pad1 - k + down) // down          per axis

A 1-D kernel is separable and applied along both axes, as in the JAX package;
a per-axis filter is passed as a (1, k) or (k, 1) 2-D kernel (the augment's
SYM6 passes). The work runs in kernel B3 (`ops.kernels.upfirdn2d`, one pass
over the 2-D taps), which carries gradients to x. On row slabs
(`parallel.spatial`) each slab runs B3 on the rows its output reads, with
its own y pads computed from its global rows.
"""

from __future__ import annotations

import numpy as np
import torch

from vtoonify_tpu_torch.ops import kernels
from vtoonify_tpu_torch.parallel import spatial


def make_kernel(k, gain: float = 1.0) -> torch.Tensor:
    """Normalized FIR kernel (float32). 1-D input stays 1-D (separable);
    normalization always uses the 2-D sum so gains match the reference."""
    k = np.asarray(k, dtype=np.float32)
    k = k / k.sum()
    if k.ndim == 1:
        return torch.from_numpy(k * np.float32(np.sqrt(gain)))
    return torch.from_numpy(k * np.float32(gain))


def _pairify(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _pad4(pad):
    pad = tuple(pad)
    if len(pad) == 2:
        return (pad[0], pad[1], pad[0], pad[1])
    return pad  # (x0, x1, y0, y1)


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Apply up-FIR-down resampling per channel.

    Args:
      x: (N, C, H, W) NCHW input.
      kernel: (kh, kw) 2-D FIR kernel, or (k,) 1-D separable kernel.
      up / down: int or (x, y) pair (reference argument order).
      pad: (pad0, pad1) applied to both axes, or (x0, x1, y0, y1).
    """
    kernel = torch.as_tensor(kernel, dtype=torch.float32)
    if kernel.ndim == 1:
        kernel = torch.outer(kernel, kernel)
    if isinstance(x, spatial.RowSharded):
        return upfirdn2d_rows(x, kernel, _pairify(up), _pairify(down), _pad4(pad))
    return kernels.upfirdn2d(x, kernel, up=_pairify(up),
                             down=_pairify(down), pad=_pad4(pad))


def upfirdn2d_rows(x, k2d, up, down, pad, fir=kernels.upfirdn2d):
    """upfirdn2d on row slabs (NCHW), each slab through `fir` (kernel B3's
    wrapper; its plain version takes the same arguments). Output row o
    reads the zero-stuffed,
    padded rows o * down - py0 + t, t < kh: the input rows r with r * up in
    that range. Each slab runs B3 on those rows with the y pads that put its
    first output row at o0 and give exactly its rows (at the frame's edges
    the frame's pads; a pad below zero crops); the x pads are the frame's."""
    (u, dn), (px0, px1, p0, p1), kh = (up[1], down[1]), pad, k2d.shape[0]
    out_h = (x.height * u + p0 + p1 - kh + dn) // dn
    spans = None
    if (u, dn) == (2, 1) and out_h == 2 * x.height:
        spans = [(2 * a, 2 * b) for a, b in x.spans]
    elif (u, dn) == (1, 1) and out_h == x.height:
        spans = x.spans

    def window(o0, o1):
        return -((p0 - o0 * dn) // u), ((o1 - 1) * dn - p0 + kh - 1) // u + 1

    def fn(t, o0, o1, a):
        b = a + t.shape[2]
        q0 = p0 + u * a - o0 * dn
        q1 = (o1 - o0 - 1) * dn + kh - u * (b - a) - q0
        return fir(t.contiguous(), k2d, up=up, down=down, pad=(px0, px1, q0, q1))

    return spatial.map_windows(x, fn, out_h, window, spans)


def upsample_2x(x, kernel_1d):
    """Reference Upsample module (model.py:32-50): x4 gain, factor-2 pads."""
    k = kernel_1d * 2.0  # sqrt(factor**2) per separable axis
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=2, down=1, pad=((p + 1) // 2 + 1, p // 2))


def downsample_2x(x, kernel_1d):
    """Reference Downsample module (model.py:53-71)."""
    p = kernel_1d.shape[0] - 2
    return upfirdn2d(x, kernel_1d, up=1, down=2, pad=((p + 1) // 2, p // 2))


def blur(x, kernel_1d, pad, upsample_factor: int = 1):
    """Reference Blur module (model.py:74-90)."""
    k = kernel_1d
    if upsample_factor > 1:
        k = k * float(upsample_factor)  # sqrt(factor**2) per separable axis
    return upfirdn2d(x, k, up=1, down=1, pad=pad)
