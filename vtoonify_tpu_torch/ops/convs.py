"""Convolution with torch semantics (port of vtoonify_tpu/ops/convs.py).

The plain convolutions of the encoder, fusion and BiSeNet were XLA
convolutions in the JAX package, never Pallas kernels, so here they are
`torch.nn.functional.conv2d` (NCHW activations, OIHW weights).
"""

from __future__ import annotations

from torch.nn.functional import conv2d  # noqa: F401  (x NCHW, w OIHW)
