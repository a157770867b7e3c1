"""Layer-wise StyleGAN model blending, the Toonify trick (port of
vtoonify_tpu/utils/blend.py: `DEFAULT_BLEND_WEIGHT`, `blend_generators`).

reference util.py:195-228: a generator's parameters and buffers are bucketed
by synthesis layer 0..17 (conv1 -> 0, to_rgb1 -> 1, convs.i -> i+1,
to_rgbs.i -> 2i+3; the style MLP, the constant input and the noises are not
blended) and lerped per layer: high * (1 - w) + low * w. The VToonify-T
trainer builds G1 from the FFHQ base (high) and a style-finetuned StyleGAN
(low) this way (train_vtoonify_t.py:348-354).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

DEFAULT_BLEND_WEIGHT = [1] * 7 + [0] * 11


def _layer_of_key(key: str) -> Optional[int]:
    """The blend layer of a generator state-dict key, or None."""
    head, _, rest = key.partition(".")
    if head == "conv1":
        return 0
    if head == "to_rgb1":
        return 1
    if head == "convs":
        return int(rest.split(".")[0]) + 1
    if head == "to_rgbs":
        return int(rest.split(".")[0]) * 2 + 3
    return None  # style MLP, input, noises: kept from the high model


@torch.no_grad()
def blend_generators(low, high, weight: Sequence[float] = DEFAULT_BLEND_WEIGHT):
    """A new Generator: the per-layer lerp of two same-config port
    Generators (`low` and `high` are left as they are)."""
    out = copy.deepcopy(high)
    lows = low.state_dict()
    for k, v in out.state_dict().items():  # tensors share the module's storage
        layer = _layer_of_key(k)
        if layer is not None:
            w = float(weight[layer])
            v.copy_(v * (1.0 - w) + lows[k] * w)
    return out
