"""BiSeNet face parsing, 19 classes, ResNet-18 context path (port of
vtoonify_tpu/models/bisenet.py: `init_bisenet`, `bisenet_apply`).

NCHW; BatchNorms run in eval mode (the network is always frozen here).
`bisenet_apply` computes the main head (the one consumers use), or with
heads=3 the two auxiliary heads too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops.interp import (
    adaptive_avg_pool,
    max_pool,
    resize_bilinear,
    resize_nearest,
)


@dataclass(frozen=True)
class BiSeNetConfig:
    n_classes: int = 19


# --- resnet18 basic block ----------------------------------------------------


class BasicBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride, generator=None):
        super().__init__()
        g = generator
        self.conv1 = L.Conv2dTorch(in_ch, out_ch, 3, bias=False, generator=g)
        self.bn1 = L.BatchNorm2d(out_ch)
        self.conv2 = L.Conv2dTorch(out_ch, out_ch, 3, bias=False, generator=g)
        self.bn2 = L.BatchNorm2d(out_ch)
        if in_ch != out_ch or stride != 1:
            self.down_conv = L.Conv2dTorch(in_ch, out_ch, 1, bias=False,
                                           generator=g)
            self.down_bn = L.BatchNorm2d(out_ch)


def basic_block(p: BasicBlock, x, stride):
    r = F.relu(L.batch_norm_2d(p.bn1, L.conv2d_torch(p.conv1, x, stride=stride,
                                                     padding=1)))
    r = L.batch_norm_2d(p.bn2, L.conv2d_torch(p.conv2, r, padding=1))
    s = x
    if hasattr(p, "down_conv"):
        s = L.batch_norm_2d(p.down_bn, L.conv2d_torch(p.down_conv, x,
                                                      stride=stride))
    return F.relu(s + r)


_RESNET_LAYERS = {"layer1": (64, 64, 1), "layer2": (64, 128, 2),
                  "layer3": (128, 256, 2), "layer4": (256, 512, 2)}


class ResNet18(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.conv1 = L.Conv2dTorch(3, 64, 7, bias=False, generator=g)
        self.bn1 = L.BatchNorm2d(64)
        for name, (in_ch, out_ch, stride) in _RESNET_LAYERS.items():
            setattr(self, name, nn.ModuleList([
                BasicBlock(in_ch, out_ch, stride, generator=g),
                BasicBlock(out_ch, out_ch, 1, generator=g)]))


def resnet18_apply(p: ResNet18, x):
    h = F.relu(L.batch_norm_2d(p.bn1, L.conv2d_torch(p.conv1, x, stride=2,
                                                     padding=3)))
    h = max_pool(h, 3, stride=2, padding=1)
    feats = []
    for name, (_, _, stride) in _RESNET_LAYERS.items():
        layer = getattr(p, name)
        h = basic_block(layer[1], basic_block(layer[0], h, stride), 1)
        feats.append(h)
    return feats[1], feats[2], feats[3]  # feat8, feat16, feat32


# --- BiSeNet modules ----------------------------------------------------------


class ConvBNReLU(nn.Module):
    def __init__(self, in_ch, out_ch, ks=3, generator=None):
        super().__init__()
        self.conv = L.Conv2dTorch(in_ch, out_ch, ks, bias=False,
                                  generator=generator)
        self.bn = L.BatchNorm2d(out_ch)


def conv_bn_relu(p: ConvBNReLU, x, stride=1, padding=1):
    return F.relu(L.batch_norm_2d(p.bn, L.conv2d_torch(p.conv, x, stride=stride,
                                                       padding=padding)))


class AttentionRefinement(nn.Module):
    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, out_ch, generator=generator)
        self.conv_atten = L.Conv2dTorch(out_ch, out_ch, 1, bias=False,
                                        generator=generator)
        self.bn_atten = L.BatchNorm2d(out_ch)


def arm_apply(p: AttentionRefinement, x):
    feat = conv_bn_relu(p.conv, x)
    atten = L.conv2d_torch(p.conv_atten, adaptive_avg_pool(feat, 1))
    atten = torch.sigmoid(L.batch_norm_2d(p.bn_atten, atten))
    return feat * atten


class FeatureFusion(nn.Module):
    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        g = generator
        self.convblk = ConvBNReLU(in_ch, out_ch, ks=1, generator=g)
        self.conv1 = L.Conv2dTorch(out_ch, out_ch // 4, 1, bias=False, generator=g)
        self.conv2 = L.Conv2dTorch(out_ch // 4, out_ch, 1, bias=False, generator=g)


def ffm_apply(p: FeatureFusion, fsp, fcp):
    feat = conv_bn_relu(p.convblk, torch.cat([fsp, fcp], dim=1), padding=0)
    atten = adaptive_avg_pool(feat, 1)
    atten = F.relu(L.conv2d_torch(p.conv1, atten))
    atten = torch.sigmoid(L.conv2d_torch(p.conv2, atten))
    return feat * atten + feat


class OutputHead(nn.Module):
    def __init__(self, in_ch, mid_ch, n_classes, generator=None):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, mid_ch, generator=generator)
        self.conv_out = L.Conv2dTorch(mid_ch, n_classes, 1, bias=False,
                                      generator=generator)


def output_head(p: OutputHead, x):
    return L.conv2d_torch(p.conv_out, conv_bn_relu(p.conv, x))


class BiSeNet(nn.Module):
    def __init__(self, cfg: BiSeNetConfig = BiSeNetConfig(), generator=None):
        super().__init__()
        g = generator
        self.resnet = ResNet18(generator=g)
        self.arm16 = AttentionRefinement(256, 128, generator=g)
        self.arm32 = AttentionRefinement(512, 128, generator=g)
        self.conv_head32 = ConvBNReLU(128, 128, generator=g)
        self.conv_head16 = ConvBNReLU(128, 128, generator=g)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, generator=g)
        self.ffm = FeatureFusion(256, 256, generator=g)
        self.conv_out = OutputHead(256, 256, cfg.n_classes, generator=g)
        self.conv_out16 = OutputHead(128, 64, cfg.n_classes, generator=g)
        self.conv_out32 = OutputHead(128, 64, cfg.n_classes, generator=g)


def init_bisenet(cfg: BiSeNetConfig = BiSeNetConfig(), generator=None) -> BiSeNet:
    return BiSeNet(cfg, generator)


def bisenet_apply(p: BiSeNet, x, heads: int = 1):
    """(B, 3, H, W) normalized input -> 19-class logits at input resolution.

    heads=1 returns only the main head (the one consumers use); heads=3
    returns all three, (main, from feat16, from feat32) (reference
    bisenet/model.py:241-254)."""
    h, w = x.shape[2:]
    feat8, feat16, feat32 = resnet18_apply(p.resnet, x)

    avg = conv_bn_relu(p.conv_avg, adaptive_avg_pool(feat32, 1), padding=0)
    feat32_arm = arm_apply(p.arm32, feat32) + avg  # broadcast over H, W
    feat32_up = resize_nearest(feat32_arm, feat16.shape[2:])
    feat32_up = conv_bn_relu(p.conv_head32, feat32_up)

    feat16_arm = arm_apply(p.arm16, feat16) + feat32_up
    feat16_up = resize_nearest(feat16_arm, feat8.shape[2:])
    feat16_up = conv_bn_relu(p.conv_head16, feat16_up)

    feat_fuse = ffm_apply(p.ffm, feat8, feat16_up)
    out = resize_bilinear(output_head(p.conv_out, feat_fuse), (h, w),
                          align_corners=True)
    if heads == 1:
        return out
    out16 = resize_bilinear(output_head(p.conv_out16, feat16_up), (h, w),
                            align_corners=True)
    out32 = resize_bilinear(output_head(p.conv_out32, feat32_up), (h, w),
                            align_corners=True)
    return out, out16, out32
