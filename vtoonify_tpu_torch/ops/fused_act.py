"""Fused bias + LeakyReLU x scale (port of vtoonify_tpu/ops/fused_act.py).

    y = leaky_relu(x + bias) * scale,   slope = 0.2, scale = sqrt(2)

The channel axis is dim 1 (NCHW activations, (N, C) linear outputs), where
the JAX package keeps it last. The work runs in kernel B2
(`ops.kernels.fused_leaky_relu`), slab by slab on row slabs
(`parallel.spatial`).
"""

from __future__ import annotations

from vtoonify_tpu_torch.ops import kernels
from vtoonify_tpu_torch.parallel import spatial

SCALE = kernels.SQRT2


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = SCALE):
    if bias is not None:
        bias = bias.to(x.dtype).contiguous()
    if isinstance(x, spatial.Sharded):
        return x.map(lambda t: kernels.fused_leaky_relu(
            t.contiguous(), spatial.local(bias, t.device), negative_slope, scale))
    return kernels.fused_leaky_relu(x.contiguous(), bias, negative_slope, scale)
