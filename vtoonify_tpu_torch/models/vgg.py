"""VGG19 multi-layer L1 perceptual loss (port of vtoonify_tpu/models/vgg.py:
`init_vgg19`, `vgg19_features`, `vgg_loss`; `convert_vgg19` is
convert/torch_import.py::convert_vgg19).

reference model/vgg.py:6-60: ImageNet normalization of [-1, 1] inputs,
features after relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1, layer
weights 1/32 .. 1, L1 distance. NCHW; its convs and pools were XLA ops in
the JAX package, so they are plain PyTorch here (cuDNN on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops.interp import max_pool

# the convs (in, out) and 2x2 max pools of each slice, up to its relu tap
# (torchvision vgg19 `features` 0:2, 2:7, 7:12, 12:21, 21:30)
SLICES = (
    ((3, 64),),
    ((64, 64), "pool", (64, 128)),
    ((128, 128), "pool", (128, 256)),
    ((256, 256), (256, 256), (256, 256), "pool", (256, 512)),
    ((512, 512), (512, 512), (512, 512), "pool", (512, 512)),
)
MEAN = (0.485 * 2 - 1, 0.456 * 2 - 1, 0.406 * 2 - 1)
STD = (0.229 * 2, 0.224 * 2, 0.225 * 2)
LAYER_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


class MaxPool2(nn.Module):
    """A 2x2 max pool's place in a slice (no parameters; the JAX package's
    "pool" marker)."""


class VGG19(nn.ModuleList):
    """The five slices, each a list of convs and pools (state-dict keys
    `{slice}.{item}.weight`, as the JAX package's nested lists)."""

    def __init__(self, generator=None):
        super().__init__([
            nn.ModuleList([MaxPool2() if item == "pool" else
                           L.Conv2dTorch(item[0], item[1], 3, generator=generator)
                           for item in sl])
            for sl in SLICES])


def init_vgg19(generator=None) -> VGG19:
    return VGG19(generator)


def vgg19_features(p: VGG19, x):
    """(B, 3, H, W) in [-1, 1] -> the five relu taps, NCHW."""
    mean = torch.tensor(MEAN, dtype=x.dtype, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, dtype=x.dtype, device=x.device)[None, :, None, None]
    h = (x - mean) / std
    feats = []
    for sl in p:
        for item in sl:
            if isinstance(item, MaxPool2):
                h = max_pool(h, 2)
            else:
                h = F.relu(L.conv2d_torch(item, h, padding=1))
        feats.append(h)
    return feats


def vgg_loss(p: VGG19, x, y):
    """sum_l w_l mean|f_l(x) - f_l(y)|, no gradient through y."""
    total = 0.0
    for w, a, b in zip(LAYER_WEIGHTS, vgg19_features(p, x),
                       vgg19_features(p, y.detach())):
        total = total + w * (a - b).abs().mean()
    return total
