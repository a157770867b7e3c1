"""pSp GradualStyleEncoder: IR-SE-50 trunk + FPN style heads (port of
vtoonify_tpu/models/psp_encoder.py: `ir_se_50_blocks`, `PSPEncoderConfig`,
`init_psp_encoder`, `psp_encoder_apply`).

reference model/encoder/encoders/psp_encoders.py:35-116 and helpers.py: 24
bottleneck_IR_SE units with taps at body indices 6/20/23, lateral 1x1s,
bilinear align-corners FPN merge, and 18 GradualStyleBlock heads producing
an (N, 18, 512) z+ code. NCHW; BatchNorm in eval mode. Its convs, BN and
PReLU were XLA ops in the JAX package (never Pallas), so they are plain
PyTorch here (cuDNN on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops.interp import adaptive_avg_pool, max_pool, resize_bilinear


def ir_se_50_blocks():
    """(in_ch, depth, stride) per unit (reference helpers.py:29-53)."""
    blocks = []
    for in_ch, depth, num in [(64, 64, 3), (64, 128, 4), (128, 256, 14),
                              (256, 512, 3)]:
        blocks.append((in_ch, depth, 2))
        blocks += [(depth, depth, 1)] * (num - 1)
    return blocks


@dataclass(frozen=True)
class PSPEncoderConfig:
    input_nc: int = 3
    n_styles: int = 18
    coarse_ind: int = 3
    middle_ind: int = 7


class SEModule(nn.Module):
    def __init__(self, ch, reduction=16, generator=None):
        super().__init__()
        self.fc1 = L.Conv2dTorch(ch, ch // reduction, 1, bias=False, generator=generator)
        self.fc2 = L.Conv2dTorch(ch // reduction, ch, 1, bias=False, generator=generator)


def se_apply(p: SEModule, x):
    a = F.relu(L.conv2d_torch(p.fc1, adaptive_avg_pool(x, 1)))
    return x * torch.sigmoid(L.conv2d_torch(p.fc2, a))


class Bottleneck(nn.Module):
    """bottleneck_IR_SE (helpers.py:97-119)."""

    def __init__(self, in_ch, depth, generator=None):
        super().__init__()
        g = generator
        self.bn0 = L.BatchNorm2d(in_ch)
        self.conv1 = L.Conv2dTorch(in_ch, depth, 3, bias=False, generator=g)
        self.prelu = L.PReLU(depth)
        self.conv2 = L.Conv2dTorch(depth, depth, 3, bias=False, generator=g)
        self.bn2 = L.BatchNorm2d(depth)
        self.se = SEModule(depth, generator=g)
        if in_ch != depth:
            self.shortcut_conv = L.Conv2dTorch(in_ch, depth, 1, bias=False, generator=g)
            self.shortcut_bn = L.BatchNorm2d(depth)


def bottleneck_apply(p: Bottleneck, x, stride):
    if hasattr(p, "shortcut_conv"):
        shortcut = L.batch_norm_2d(p.shortcut_bn,
                                   L.conv2d_torch(p.shortcut_conv, x, stride=stride))
    else:
        shortcut = max_pool(x, 1, stride=stride) if stride > 1 else x
    res = L.batch_norm_2d(p.bn0, x)
    res = L.prelu(p.prelu, L.conv2d_torch(p.conv1, res, padding=1))
    res = L.batch_norm_2d(p.bn2, L.conv2d_torch(p.conv2, res, stride=stride, padding=1))
    return se_apply(p.se, res) + shortcut


class GradualStyleBlock(nn.Module):
    """psp_encoders.py:11-32."""

    def __init__(self, in_c, out_c, spatial, generator=None):
        super().__init__()
        g = generator
        self.convs = nn.ModuleList([
            L.Conv2dTorch(in_c if i == 0 else out_c, out_c, 3, generator=g)
            for i in range(int(np.log2(spatial)))])
        self.linear = L.EqualLinear(out_c, out_c, generator=g)


def gradual_style_block(p: GradualStyleBlock, x):
    for cp in p.convs:
        x = F.leaky_relu(L.conv2d_torch(cp, x, stride=2, padding=1), 0.01)
    return L.equal_linear(p.linear, x.reshape(x.shape[0], -1))


class PSPEncoder(nn.Module):
    def __init__(self, cfg: PSPEncoderConfig = PSPEncoderConfig(), generator=None):
        super().__init__()
        g = generator
        self.input_conv = L.Conv2dTorch(cfg.input_nc, 64, 3, bias=False, generator=g)
        self.input_bn = L.BatchNorm2d(64)
        self.input_prelu = L.PReLU(64)
        self.body = nn.ModuleList([Bottleneck(i, d, generator=g)
                                   for i, d, _ in ir_se_50_blocks()])
        self.styles = nn.ModuleList([
            GradualStyleBlock(512, 512, 16 if i < cfg.coarse_ind else
                              32 if i < cfg.middle_ind else 64, generator=g)
            for i in range(cfg.n_styles)])
        self.latlayer1 = L.Conv2dTorch(256, 512, 1, generator=g)
        self.latlayer2 = L.Conv2dTorch(128, 512, 1, generator=g)


def init_psp_encoder(cfg: PSPEncoderConfig = PSPEncoderConfig(),
                     generator=None) -> PSPEncoder:
    return PSPEncoder(cfg, generator)


def psp_encoder_apply(p: PSPEncoder, cfg: PSPEncoderConfig, x,
                      latent_avg: Optional[torch.Tensor] = None):
    """(B, 3, 256, 256) aligned face in [-1, 1] -> (B, n_styles, 512) z+
    code; with `latent_avg` ((n_styles, 512) or (512,)) it is added, as the
    reference loader's forward hook does (util.py:157-160)."""
    h = L.conv2d_torch(p.input_conv, x, padding=1)
    h = L.prelu(p.input_prelu, L.batch_norm_2d(p.input_bn, h))
    taps = {}
    for i, (bp, (_, _, stride)) in enumerate(zip(p.body, ir_se_50_blocks())):
        h = bottleneck_apply(bp, h, stride)
        if i in (6, 20, 23):
            taps[i] = h
    c1, c2, c3 = taps[6], taps[20], taps[23]

    latents = [gradual_style_block(p.styles[j], c3) for j in range(cfg.coarse_ind)]
    p2 = (resize_bilinear(c3, c2.shape[2:], align_corners=True)
          + L.conv2d_torch(p.latlayer1, c2))
    latents += [gradual_style_block(p.styles[j], p2)
                for j in range(cfg.coarse_ind, cfg.middle_ind)]
    p1 = (resize_bilinear(p2, c1.shape[2:], align_corners=True)
          + L.conv2d_torch(p.latlayer2, c1))
    latents += [gradual_style_block(p.styles[j], p1)
                for j in range(cfg.middle_ind, cfg.n_styles)]
    out = torch.stack(latents, dim=1)
    if latent_avg is not None:
        la = latent_avg.to(out.dtype)
        out = out + (la[None] if la.ndim == 2 else la[None, None])
    return out
