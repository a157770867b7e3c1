"""Convolutions with torch semantics (port of vtoonify_tpu/ops/convs.py).

The plain convolutions of the encoder, fusion and BiSeNet, and the
transposed convolution of the non-fused x2 up conv, were XLA convolutions in
the JAX package, never Pallas kernels, so here they are
`torch.nn.functional` calls (NCHW activations; conv weights OIHW,
transposed-conv weights torch's (Cin, Cout // groups, kh, kw)). `conv2d` also
takes a row-sharded activation (`parallel.spatial`).
"""

from __future__ import annotations

import torch.nn.functional as F

from vtoonify_tpu_torch.parallel import spatial


def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """F.conv2d (x NCHW, w OIHW), or `spatial.conv2d` on a sharded x."""
    if isinstance(x, spatial.Sharded):
        return spatial.conv2d(x, w, bias, stride, padding, dilation, groups)
    return F.conv2d(x, w, bias, stride, padding, dilation, groups)


def conv_transpose2d(x, w, stride=2, padding=0, groups=1):
    """torch.nn.functional.conv_transpose2d (the gradient of conv2d), with
    the JAX package's default stride 2. x (N, Cin, H, W); w (Cin,
    Cout // groups, kh, kw), torch's layout (`convert.from_jax` maps the
    JAX package's (kh, kw, Cout // groups, Cin) to it). Output size
    (in - 1) * stride - 2 * padding + k."""
    return F.conv_transpose2d(x, w, stride=stride, padding=padding, groups=groups)
