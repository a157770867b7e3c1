"""DualStyleGAN (port of vtoonify_tpu/models/dualstylegan.py:
`DualStyleGANConfig`, `init_dualstylegan`, `color_transform`,
`prepare_exstyles`, `dualstylegan_apply`).

VToonify-D uses DualStyleGAN's StyleGAN2 synthesis layers, its T_c color
transform (for the encoder's ModRes blocks) and its identity-initialized
structure transforms T_s (on the generator styles of layers >= 7); the
stage-2 trainer runs the whole DualStyleGAN as its frozen teacher.
`dualstylegan_apply` is the plain unpacked walk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.parallel.tensor import whole


@dataclass(frozen=True)
class DualStyleGANConfig:
    size: int = 1024
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    channel_max: int = 512
    res_index: int = 6  # floored to even by the reference (dualstylegan.py:60)

    @property
    def generator(self) -> G.GeneratorConfig:
        return G.GeneratorConfig(
            size=self.size, style_dim=self.style_dim, n_mlp=self.n_mlp,
            channel_multiplier=self.channel_multiplier,
            channel_max=self.channel_max,
        )

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    @property
    def res_index_eff(self) -> int:
        return self.res_index // 2 * 2


def _identity_equal_linear(dim=512, generator=None) -> L.EqualLinear:
    """T_s init: eye * sqrt(dim) + 0.01 * randn (dualstylegan.py:70-76)."""
    p = L.EqualLinear(dim, dim, generator=generator)
    with torch.no_grad():
        p.weight.copy_(torch.eye(dim) * math.sqrt(dim)
                       + 0.01 * torch.randn((dim, dim), generator=generator))
    return p


class DualStyleGAN(nn.Module):
    def __init__(self, cfg: DualStyleGANConfig, generator=None):
        super().__init__()
        g = generator
        gcfg = cfg.generator
        ch = gcfg.channels
        # color transform T_c: PixelNorm + (n_mlp - 6) EqualLinear(0.01 lr)
        self.style = nn.ModuleList(
            [L.EqualLinear(512, 512, generator=g) for _ in range(cfg.n_mlp - 6)])
        self.generator = G.Generator(gcfg, generator=g)
        res = [L.AdaResBlock(ch[4], generator=g)]  # for conv1
        for i in range(3, cfg.log_size + 1):
            out_ch = ch[2 ** i]
            for _ in range(2):
                res.append(L.AdaResBlock(out_ch, generator=g)
                           if i < 3 + cfg.res_index_eff // 2
                           else _identity_equal_linear(generator=g))
        res.append(_identity_equal_linear(generator=g))  # to_rgb of last pair
        self.res = nn.ModuleList(res)


def init_dualstylegan(cfg: DualStyleGANConfig, generator=None) -> DualStyleGAN:
    return DualStyleGAN(cfg, generator)


def color_transform(p: DualStyleGAN, exstyle):
    """T_c mapping (PixelNorm + small MLP), dualstylegan.py:51-55."""
    x = L.pixel_norm(exstyle)
    for lin in p.style:
        x = L.equal_linear(lin, x, lr_mul=0.01, activation=True)
    return x


def prepare_exstyles(p: DualStyleGAN, cfg: DualStyleGANConfig, exstyles):
    """-> (resstyles, adastyles): T_c-mapped codes for AdaIN, raw codes for
    T_s, each (B, n_latent, 512)."""
    if exstyles.ndim < 3:
        rs = color_transform(p, exstyles)
        return (rs[:, None, :].expand(-1, cfg.n_latent, -1),
                exstyles[:, None, :].expand(-1, cfg.n_latent, -1))
    nb, nl, nd = exstyles.shape
    resstyles = color_transform(p, exstyles.reshape(nb * nl, nd)).reshape(nb, nl, nd)
    return resstyles, exstyles


def dualstylegan_apply(p: DualStyleGAN, cfg: DualStyleGANConfig, styles,
                       exstyles, *, input_is_latent=False,
                       z_plus_latent=False, truncation=1.0,
                       truncation_latent=None, inject_index=None,
                       noise: Optional[Sequence] = None, use_res=True,
                       fuse_index=18, interp_weights: Sequence = (1.0,) * 18,
                       return_feat=False):
    """reference dualstylegan.py:84-194. `interp_weights` are floats or 0-d
    tensors (one per layer); `noise` is num_layers (B, 1, s, s) tensors or
    Nones. Returns the image, or (feat, skip) after the ModRes region with
    `return_feat`."""
    gcfg = cfg.generator
    gp = p.generator
    latent = G.styles_to_latent(
        gp, gcfg, styles, input_is_latent=input_is_latent,
        z_plus_latent=z_plus_latent, truncation=truncation,
        truncation_latent=truncation_latent, inject_index=inject_index)
    if noise is None:
        noise = [None] * gcfg.num_layers
    if use_res:
        resstyles, adastyles = prepare_exstyles(p, cfg, exstyles)
    res = p.res
    ri = cfg.res_index_eff
    wts = interp_weights

    def blend(i):
        return wts[i] * L.equal_linear(res[i], adastyles[:, i]) + (1 - wts[i]) * latent[:, i]

    batch = latent.shape[0]
    out = whole(gp.input, latent.device).to(latent.dtype).expand(batch, -1, -1, -1)
    out = L.styled_conv(gp.conv1, out, latent[:, 0], noise=noise[0])
    if use_res and fuse_index > 0:
        out = L.ada_res_block(res[0], out, resstyles[:, 0], wts[0])
    skip = L.to_rgb(gp.to_rgb1, out, latent[:, 1])

    i = 1
    for idx in range(len(gp.to_rgbs)):
        # per-layer styles, T_s-blended past the ModRes region
        s1 = blend(i) if use_res and fuse_index >= i and i > ri else latent[:, i]
        s2 = (blend(i + 1) if use_res and fuse_index >= i + 1 and i > ri
              else latent[:, i + 1])
        s3 = (blend(i + 2) if use_res and fuse_index >= i + 2 and i >= ri - 1
              else latent[:, i + 2])
        out = L.styled_conv(gp.convs[2 * idx], out, s1, noise=noise[2 * idx + 1],
                            upsample=True)
        if use_res and fuse_index >= i and i <= ri:
            out = L.ada_res_block(res[i], out, resstyles[:, i], wts[i])
        out = L.styled_conv(gp.convs[2 * idx + 1], out, s2,
                            noise=noise[2 * idx + 2])
        if use_res and fuse_index >= i + 1 and i <= ri:
            out = L.ada_res_block(res[i + 1], out, resstyles[:, i + 1], wts[i + 1])
        skip = L.to_rgb(gp.to_rgbs[idx], out, s3, skip)
        i += 2
        if i > ri and return_feat:
            return out, skip
    return skip
