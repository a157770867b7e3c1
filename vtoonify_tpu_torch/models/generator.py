"""StyleGAN2 generator parameters and mapping network (port of
vtoonify_tpu/models/generator.py: `channel_table`, `GeneratorConfig`,
`init_generator`, `style_mlp`).

The synthesis walk the product runs lives in models/vtoonify.py; this module
holds the full parameter tree (mapping MLP, constant input, every styled conv
pair and ToRGB, the stored noise images) so checkpoints load strictly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from vtoonify_tpu_torch.nn import layers as L


def channel_table(channel_multiplier: int = 2, channel_max: int = 512) -> dict:
    """reference model.py:422-432; `channel_max` caps every entry."""
    return {
        res: min(c, channel_max)
        for res, c in {
            4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * channel_multiplier,
            128: 128 * channel_multiplier,
            256: 64 * channel_multiplier,
            512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier,
        }.items()
    }


@dataclass(frozen=True)
class GeneratorConfig:
    size: int = 1024
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    channel_max: int = 512
    lr_mlp: float = 0.01

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    @property
    def num_layers(self) -> int:
        return (self.log_size - 2) * 2 + 1

    @property
    def channels(self) -> dict:
        return channel_table(self.channel_multiplier, self.channel_max)


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig, generator=None):
        super().__init__()
        ch = cfg.channels
        sd = cfg.style_dim
        g = generator
        self.style = nn.ModuleList(
            [L.EqualLinear(sd, sd, generator=g) for _ in range(cfg.n_mlp)])
        self.input = L._param(torch.randn((1, ch[4], 4, 4), generator=g))
        self.conv1 = L.StyledConv(ch[4], ch[4], 3, sd, generator=g)
        self.to_rgb1 = L.ToRGB(ch[4], sd, generator=g)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, cfg.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(L.StyledConv(in_ch, out_ch, 3, sd, generator=g))
            self.convs.append(L.StyledConv(out_ch, out_ch, 3, sd, generator=g))
            self.to_rgbs.append(L.ToRGB(out_ch, sd, generator=g))
            in_ch = out_ch
        self.noises = nn.ParameterList([
            L._param(torch.randn((1, 1, 2 ** ((i + 5) // 2),
                                  2 ** ((i + 5) // 2)), generator=g))
            for i in range(cfg.num_layers)
        ])


def init_generator(cfg: GeneratorConfig, generator=None) -> Generator:
    return Generator(cfg, generator)


def style_mlp(p: Generator, cfg: GeneratorConfig, z):
    """Mapping network: PixelNorm -> n_mlp x EqualLinear(fused_lrelu)."""
    x = L.pixel_norm(z)
    for lin in p.style:
        x = L.equal_linear(lin, x, lr_mul=cfg.lr_mlp, activation=True)
    return x
