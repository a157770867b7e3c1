"""LPIPS perceptual distance, net-lin with a VGG16 backbone (port of
vtoonify_tpu/models/lpips.py: `init_lpips`, `lpips_apply`).

reference model/stylegan/lpips/networks_basic.py:27-110: input scaling ->
VGG16 taps (relu1_2/2_2/3_3/4_3/5_3) -> unit-normalize over channels ->
squared difference -> learned 1x1 `lin` heads -> spatial mean, summed over
the five taps. NCHW; plain PyTorch (cuDNN on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops.interp import max_pool

# VGG16 conv channel plan per stage (taps after each stage's last relu)
_VGG_PLAN = ((3, 64, 64), (64, 128, 128), (128, 256, 256, 256),
             (256, 512, 512, 512), (512, 512, 512, 512))
SCALE_SHIFT = (-0.030, -0.088, -0.188)
SCALE_SCALE = (0.458, 0.448, 0.450)


class LinHead(nn.Module):
    def __init__(self, ch, generator=None):
        super().__init__()
        self.weight = L._param(torch.rand((1, ch, 1, 1), generator=generator))


class LPIPS(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.vgg = nn.ModuleList([
            nn.ModuleList([L.Conv2dTorch(st[i], st[i + 1], 3, generator=g)
                           for i in range(len(st) - 1)])
            for st in _VGG_PLAN])
        self.lins = nn.ModuleList([LinHead(st[-1], generator=g) for st in _VGG_PLAN])


def init_lpips(generator=None) -> LPIPS:
    return LPIPS(generator)


def _vgg_features(p: LPIPS, x):
    feats = []
    h = x
    for si, stage in enumerate(p.vgg):
        if si > 0:
            h = max_pool(h, 2)
        for conv in stage:
            h = F.relu(L.conv2d_torch(conv, h, padding=1))
        feats.append(h)
    return feats


def _unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x.square(), dim=1, keepdim=True)) + eps)


def lpips_apply(p: LPIPS, x0, x1):
    """(B, 3, H, W) pairs in [-1, 1] -> (B, 1, 1, 1) distances."""
    shift = torch.tensor(SCALE_SHIFT, dtype=x0.dtype, device=x0.device)[None, :, None, None]
    scale = torch.tensor(SCALE_SCALE, dtype=x0.dtype, device=x0.device)[None, :, None, None]
    f0 = _vgg_features(p, (x0 - shift) / scale)
    f1 = _vgg_features(p, (x1 - shift) / scale)
    val = 0.0
    for a, b, lin in zip(f0, f1, p.lins):
        diff = (_unit_normalize(a) - _unit_normalize(b)).square()
        val = val + F.conv2d(diff, lin.weight.to(diff.dtype)).mean(dim=(2, 3), keepdim=True)
    return val
