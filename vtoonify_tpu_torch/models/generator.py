"""StyleGAN2 generator and discriminator (port of
vtoonify_tpu/models/generator.py: `channel_table`, `GeneratorConfig`,
`init_generator`, `style_mlp`, `styles_to_latent`, `make_noise`,
`generator_apply`, `generate`, `mean_latent`, `DiscriminatorConfig`,
`init_discriminator`, `minibatch_stddev`, `discriminator_apply`).

The generator holds the full parameter tree (mapping MLP, constant input,
every styled conv pair and ToRGB, the stored noise images) so checkpoints
load strictly. `generator_apply` is the plain unpacked walk from the 4 px
constant (the JAX package's space-to-depth packed stages are the same
algebra laid out for the TPU); noise images are NCHW (B, 1, s, s).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.parallel import collectives as C
from vtoonify_tpu_torch.parallel.tensor import whole


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


def styles_to_latent(p: Generator, cfg: GeneratorConfig, styles: Sequence, *,
                     input_is_latent=False, z_plus_latent=False,
                     truncation=1.0, truncation_latent=None,
                     inject_index=None):
    """Reference forward's style-preparation half (model.py:516-565)."""
    if not input_is_latent:
        mapped = []
        for s in styles:
            if not z_plus_latent:
                mapped.append(style_mlp(p, cfg, s))
            else:
                nb, nl, nd = s.shape
                mapped.append(style_mlp(p, cfg, s.reshape(nb * nl, nd))
                              .reshape(nb, nl, nd))
        styles = mapped
    if truncation < 1:
        styles = [truncation_latent + truncation * (s - truncation_latent)
                  for s in styles]
    if len(styles) < 2:
        s = styles[0]
        return s[:, None, :].expand(-1, cfg.n_latent, -1) if s.ndim < 3 else s
    if inject_index is None:
        raise ValueError("styles_to_latent: two styles need inject_index")
    s0, s1 = styles
    if s0.ndim < 3:
        return torch.cat([s0[:, None, :].expand(-1, inject_index, -1),
                          s1[:, None, :].expand(-1, cfg.n_latent - inject_index,
                                                -1)], dim=1)
    return torch.cat([s0[:, :inject_index], s1[:, inject_index:]], dim=1)


def make_noise(p: Generator, cfg: GeneratorConfig, generator=None,
               randomize=True, batch=1, dtype=torch.float32, device=None):
    """Per-layer noise images (B, 1, s, s): standard normal draws from the
    explicit `torch.Generator` (made in float32 on the generator's device,
    then cast to `dtype` on `device`), or the stored buffers."""
    if not randomize:
        return list(p.noises)
    gdev = generator.device if generator is not None else None
    return [torch.randn((batch, 1, s, s), generator=generator, device=gdev)
            .to(device=device, dtype=dtype)
            for s in (2 ** ((i + 5) // 2) for i in range(cfg.num_layers))]


def generator_apply(p: Generator, cfg: GeneratorConfig, latent,
                    noise: Optional[Sequence] = None,
                    return_feature_ind: int = 999):
    """Synthesis on a prepared W+ latent (B, n_latent, style_dim),
    reference model.py:567-590. `noise`: num_layers tensors (B, 1, s, s) or
    Nones. Returns the (B, 3, size, size) image, or (feat, skip) once layer
    index `return_feature_ind` is passed (model.py:581-582)."""
    if noise is None:
        noise = [None] * cfg.num_layers
    batch = latent.shape[0]
    out = whole(p.input, latent.device).to(latent.dtype).expand(batch, -1, -1, -1)
    out = L.styled_conv(p.conv1, out, latent[:, 0], noise=noise[0])
    skip = L.to_rgb(p.to_rgb1, out, latent[:, 1])
    i = 1
    for idx in range(len(p.to_rgbs)):
        out = L.styled_conv(p.convs[2 * idx], out, latent[:, i],
                            noise=noise[2 * idx + 1], upsample=True)
        out = L.styled_conv(p.convs[2 * idx + 1], out, latent[:, i + 1],
                            noise=noise[2 * idx + 2])
        skip = L.to_rgb(p.to_rgbs[idx], out, latent[:, i + 2], skip)
        i += 2
        if i > return_feature_ind:
            return out, skip
    return skip


def generate(p: Generator, cfg: GeneratorConfig, styles, *,
             input_is_latent=False, z_plus_latent=False, truncation=1.0,
             truncation_latent=None, inject_index=None, noise=None,
             return_latents=False):
    """Full reference-forward equivalent (styles -> image)."""
    latent = styles_to_latent(
        p, cfg, styles, input_is_latent=input_is_latent,
        z_plus_latent=z_plus_latent, truncation=truncation,
        truncation_latent=truncation_latent, inject_index=inject_index)
    img = generator_apply(p, cfg, latent, noise=noise)
    return (img, latent) if return_latents else img


def mean_latent(p: Generator, cfg: GeneratorConfig, generator, n_latent: int):
    """The mean (1, style_dim) w of `n_latent` standard normal z drawn
    from the explicit `torch.Generator` (on its device, float32)."""
    z = torch.randn((n_latent, cfg.style_dim), generator=generator,
                    device=generator.device)
    return style_mlp(p, cfg, z.to(p.style[0].weight.device)).mean(0, keepdim=True)


# ---------------------------------------------------------------------------
# discriminator (reference model.py:661-718)


@dataclass(frozen=True)
class DiscriminatorConfig:
    size: int = 256
    channel_multiplier: int = 2
    channel_max: int = 512

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def channels(self) -> dict:
        return channel_table(self.channel_multiplier, self.channel_max)


class Discriminator(nn.Module):
    """The StyleGAN2 discriminator. Under a process group of more than one
    rank its minibatch-stddev layer is a collective (`minibatch_stddev`):
    every rank must run each discriminator call together, with the same
    shapes. A call made on one rank alone (an evaluation or a sample grid on
    rank 0) blocks in that collective; make such calls outside the group."""

    def __init__(self, cfg: DiscriminatorConfig, generator=None):
        super().__init__()
        g = generator
        ch = cfg.channels
        self.conv_in = L.ConvLayer(3, ch[cfg.size], 1, generator=g)
        self.blocks = nn.ModuleList()
        in_ch = ch[cfg.size]
        for i in range(cfg.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            self.blocks.append(L.ResBlock(in_ch, out_ch, generator=g))
            in_ch = out_ch
        # consumes cat[features, minibatch stddev]: one merged weight
        self.final_conv = L.ConvLayer(in_ch + 1, ch[4], 3, generator=g)
        self.final_linear = nn.ModuleList([
            L.EqualLinear(ch[4] * 4 * 4, ch[4], generator=g),
            L.EqualLinear(ch[4], 1, generator=g)])


def init_discriminator(cfg: DiscriminatorConfig, generator=None) -> Discriminator:
    return Discriminator(cfg, generator)


def minibatch_stddev(x, stddev_group: int = 4, stddev_feat: int = 1):
    """reference model.py:704-712 WITHOUT the final concat: the per-group
    stddev map (B, stddev_feat, H, W) in x's dtype.

    When the batch is split over the ranks of a process group, the groups
    are formed over the global batch, as the JAX package's data parallelism
    forms them over its one logical array: each rank gathers every rank's
    rows (differentiably) and keeps the map of its own. That gather is a
    collective, so every rank must make the call together."""
    if C.spans_ranks():
        return C.local_rows(_minibatch_stddev(C.gather_batch(x), stddev_group,
                                              stddev_feat))
    return _minibatch_stddev(x, stddev_group, stddev_feat)


def _minibatch_stddev(x, stddev_group, stddev_feat):
    b, c, h, w = x.shape
    group = min(b, stddev_group)
    y = x.reshape(group, b // group, stddev_feat, c // stddev_feat, h, w)
    std = torch.sqrt(torch.var(y, dim=0, unbiased=False) + 1e-8)
    std = std.mean(dim=(2, 3, 4))  # (b // group, feat)
    return std[:, :, None, None].repeat(group, 1, h, w).to(x.dtype)


def discriminator_features(p: Discriminator, x):
    """conv_in -> res blocks -> final conv on [x, stddev] -> flatten (NCHW
    order, as torch) -> final_linear[0] with activation."""
    out = L.conv_layer(p.conv_in, x, 1)
    for bp in p.blocks:
        out = L.res_block(bp, out)
    out = L.conv_layer(p.final_conv, torch.cat([out, minibatch_stddev(out)], 1), 3)
    out = out.reshape(out.shape[0], -1)
    return L.equal_linear(p.final_linear[0], out, activation=True)


def discriminator_apply(p: Discriminator, cfg: DiscriminatorConfig, x):
    """(B, 3, size, size) -> (B, 1) logits."""
    return L.equal_linear(p.final_linear[1], discriminator_features(p, x))
