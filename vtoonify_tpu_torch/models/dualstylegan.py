"""DualStyleGAN parameters and color transform (port of
vtoonify_tpu/models/dualstylegan.py: `DualStyleGANConfig`,
`init_dualstylegan`, `color_transform`).

VToonify-D uses DualStyleGAN's StyleGAN2 synthesis layers, its T_c color
transform (for the encoder's ModRes blocks) and its identity-initialized
structure transforms T_s (on the generator styles of layers >= 7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.nn import layers as L


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
