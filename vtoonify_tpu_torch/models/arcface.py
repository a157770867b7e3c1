"""ArcFace IR-SE backbone and the identity loss (port of
vtoonify_tpu/models/arcface.py: `init_arcface_backbone`, `arcface_apply`,
`id_loss`, `resize_to_112`).

reference model/encoder/encoders/model_irse.py:9-84 and
model/encoder/criteria/id_loss.py:6-33: the IR-SE-50 trunk (the pSp
encoder's bottlenecks, models/psp_encoder.py), then BN -> Dropout (identity:
inference and loss only) -> Flatten -> Linear -> BatchNorm1d(affine=False),
L2-normalized; IDLoss = mean(1 - <f(y_hat), f(y)>) on the [35:223, 32:220]
face crop resized to 112 px. NCHW, BatchNorm in eval mode; plain PyTorch
(XLA ops in the JAX package, cuDNN on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from vtoonify_tpu_torch.models.psp_encoder import (
    Bottleneck,
    bottleneck_apply,
    ir_se_50_blocks,
)
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops.interp import adaptive_avg_pool, resize_bilinear


class BatchNorm1dStats(nn.Module):
    """BatchNorm1d(affine=False)'s running statistics."""

    def __init__(self, ch):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))


class ArcFace(nn.Module):
    def __init__(self, input_size: int = 112, generator=None):
        super().__init__()
        g = generator
        spatial = 7 if input_size == 112 else 14
        self.input_conv = L.Conv2dTorch(3, 64, 3, bias=False, generator=g)
        self.input_bn = L.BatchNorm2d(64)
        self.input_prelu = L.PReLU(64)
        self.body = nn.ModuleList([Bottleneck(i, d, generator=g)
                                   for i, d, _ in ir_se_50_blocks()])
        self.out_bn = L.BatchNorm2d(512)
        self.out_linear = L.LinearTorch(512 * spatial * spatial, 512, generator=g)
        self.out_bn1d = BatchNorm1dStats(512)


def init_arcface_backbone(input_size: int = 112, generator=None) -> ArcFace:
    return ArcFace(input_size, generator)


def arcface_apply(p: ArcFace, x):
    """(B, 3, S, S) in [-1, 1] -> (B, 512) L2-normalized embeddings."""
    h = L.conv2d_torch(p.input_conv, x, padding=1)
    h = L.prelu(p.input_prelu, L.batch_norm_2d(p.input_bn, h))
    for bp, (_, _, stride) in zip(p.body, ir_se_50_blocks()):
        h = bottleneck_apply(bp, h, stride)
    h = L.batch_norm_2d(p.out_bn, h)
    h = L.linear_torch(p.out_linear, h.reshape(h.shape[0], -1))  # NCHW flatten
    bn = p.out_bn1d
    h = (h - bn.running_mean.to(h.dtype)) * torch.rsqrt(bn.running_var + 1e-5).to(h.dtype)
    return h / torch.linalg.vector_norm(h, dim=1, keepdim=True)


def resize_to_112(x):
    """AdaptiveAvgPool2d((112, 112)) where 112 divides the size; else (the
    188 px crop) the bilinear resize the JAX package takes in its place."""
    if x.shape[2] % 112 == 0:
        return adaptive_avg_pool(x, 112)
    return resize_bilinear(x, (112, 112), align_corners=False)


def id_loss(p: ArcFace, y_hat, y):
    """reference id_loss.py:17-33; inputs (B, 3, 256, 256) in [-1, 1]; no
    gradient through y."""

    def feats(img):
        return arcface_apply(p, resize_to_112(img[:, :, 35:223, 32:220]))

    yf = feats(y).detach()
    return (1.0 - (feats(y_hat) * yf).sum(dim=1)).mean()
