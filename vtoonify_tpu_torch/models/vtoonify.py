"""VToonify — the product model, T and D backbones, and the stage-2
conditional discriminator (port of vtoonify_tpu/models/vtoonify.py:
`VToonifyConfig`, `init_vtoonify`, `fusion_apply`, `vtoonify_res_block`,
`prepare_styles`, `vtoonify_apply`, `zplus2wplus`,
`CondDiscriminatorConfig`, `init_cond_discriminator`,
`cond_discriminator_apply`).

Activations are NCHW. Every synthesis stage runs the plain (unpacked)
styled_conv / to_rgb path; the JAX package's space-to-depth packed variants
for narrow stages are the same algebra laid out for the TPU and are not
ported, nor is `packed_out`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vtoonify_tpu_torch.models import dualstylegan as D
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.nn import layers as L


@dataclass(frozen=True)
class VToonifyConfig:
    in_size: int = 256
    out_size: int = 1024
    img_channels: int = 3
    parsing_channels: int = 19  # BiSeNet classes concatenated to RGB
    style_channels: int = 512
    num_mlps: int = 8
    channel_multiplier: int = 2
    channel_max: int = 512
    num_res_layers: int = 6
    backbone: str = "dualstylegan"  # or "toonify"

    @property
    def generator(self) -> G.GeneratorConfig:
        return G.GeneratorConfig(
            size=self.out_size, style_dim=self.style_channels,
            n_mlp=self.num_mlps, channel_multiplier=self.channel_multiplier,
            channel_max=self.channel_max,
        )

    @property
    def dualstylegan(self) -> D.DualStyleGANConfig:
        return D.DualStyleGANConfig(
            size=self.out_size, style_dim=self.style_channels,
            n_mlp=self.num_mlps, channel_multiplier=self.channel_multiplier,
            channel_max=self.channel_max,
        )

    @property
    def channels(self) -> dict:
        return G.channel_table(self.channel_multiplier, self.channel_max)

    @property
    def encoder_res(self) -> tuple:
        return tuple(2 ** i for i in range(int(math.log2(self.in_size)), 4, -1))

    @property
    def n_latent(self) -> int:
        return int(math.log2(self.out_size)) * 2 - 2


# ---------------------------------------------------------------------------
# Fusion (reference vtoonify.py:106-128)


class Fusion(nn.Module):
    def __init__(self, in_ch, skip_ch, out_ch, generator=None):
        super().__init__()
        g = generator
        self.conv = L.Conv2dTorch(in_ch + skip_ch, out_ch, 3, generator=g)
        self.norm = L.AdaptiveInstanceNorm(in_ch + skip_ch, 128, generator=g)
        self.conv2 = L.Conv2dTorch(in_ch + skip_ch, 1, 3, generator=g)
        self.linear = nn.ModuleList([L.LinearTorch(1, 64, generator=g),
                                     L.LinearTorch(64, 128, generator=g)])


def fusion_apply(p: Fusion, f_G, f_E, d_s):
    b, c = f_G.shape[:2]
    # the (f32) degree scalar is cast to the activation dtype first, so a
    # bf16 graph stays bf16 (JAX models/vtoonify.py:97-100); a Python degree
    # is filled on the device, since copying a host scalar there would wait
    # on it
    deg = (torch.as_tensor(d_s, device=f_G.device) if torch.is_tensor(d_s)
           else torch.full((), d_s, dtype=torch.float32, device=f_G.device))
    label = torch.zeros((b, 1), dtype=f_G.dtype, device=f_G.device) + deg.to(f_G.dtype)
    label = F.leaky_relu(L.linear_torch(p.linear[0], label), 0.2)
    label = F.leaky_relu(L.linear_torch(p.linear[1], label), 0.2)
    # cat[f_G, |f_G - f_E|] -> AdaIN -> conv, with the per-channel instance
    # norm applied to each half (the same values as the reference's concat)
    st = L.linear_torch(p.norm.style, label)  # (B, 4c): gamma | beta over cat
    diff = torch.abs(f_G - f_E)
    na = (st[:, 0:c, None, None] * L.instance_norm_2d(f_G)
          + st[:, 2 * c:3 * c, None, None])
    nb = (st[:, c:2 * c, None, None] * L.instance_norm_2d(diff)
          + st[:, 3 * c:4 * c, None, None])
    m_E = torch.tanh(F.relu(L.conv2d_torch_cat2(p.conv2, na, nb, padding=1)))
    f_out = L.conv2d_torch_cat2(p.conv, f_G, f_E * m_E, padding=1)
    return f_out, m_E


# ---------------------------------------------------------------------------
# VToonifyResBlock (reference vtoonify.py:92-104)


class VToonifyResBlock(nn.Module):
    def __init__(self, fin, generator=None):
        super().__init__()
        self.conv1 = L.Conv2dTorch(fin, fin, 3, generator=generator)
        self.conv2 = L.Conv2dTorch(fin, fin, 3, generator=generator)


def vtoonify_res_block(p: VToonifyResBlock, x):
    out = F.leaky_relu(L.conv2d_torch(p.conv1, x, padding=1), 0.2)
    out = F.leaky_relu(L.conv2d_torch(p.conv2, out, padding=1), 0.2)
    return (out + x) / math.sqrt(2)


# ---------------------------------------------------------------------------
# VToonify


class Encoder(nn.Module):
    def __init__(self, cfg: VToonifyConfig, generator=None):
        super().__init__()
        g = generator
        ch = cfg.channels
        self.stem = nn.ModuleList([
            L.Conv2dTorch(cfg.img_channels + cfg.parsing_channels, 32, 3,
                          generator=g),
            L.Conv2dTorch(32, ch[cfg.in_size], 3, generator=g),
        ])
        self.down = nn.ModuleList()
        for res in cfg.encoder_res:
            if res > 32:
                self.down.append(nn.ModuleList([
                    L.Conv2dTorch(ch[res], ch[res // 2], 3, generator=g),
                    L.Conv2dTorch(ch[res // 2], ch[res // 2], 3, generator=g),
                ]))
            else:
                self.resblocks = nn.ModuleList([
                    VToonifyResBlock(ch[res], generator=g)
                    for _ in range(cfg.num_res_layers)])
                self.final = L.Conv2dTorch(ch[res], cfg.img_channels, 1,
                                           generator=g)


class VToonify(nn.Module):
    def __init__(self, cfg: VToonifyConfig, generator=None):
        super().__init__()
        g = generator
        ch = cfg.channels
        is_d = cfg.backbone == "dualstylegan"
        self.generator = (D.DualStyleGAN(cfg.dualstylegan, generator=g) if is_d
                          else G.Generator(cfg.generator, generator=g))
        self.encoder = Encoder(cfg, generator=g)
        # fusion modules, ordered low -> high res
        self.fusion_out = nn.ModuleList()
        self.fusion_skip = nn.ModuleList()
        for res in cfg.encoder_res[::-1]:
            c = ch[res]
            self.fusion_out.append(Fusion(c, c, c, generator=g) if is_d else
                                   L.Conv2dTorch(c * 2, c, 3, generator=g))
            self.fusion_skip.append(L.Conv2dTorch(cfg.img_channels + c,
                                                  cfg.img_channels, 3,
                                                  generator=g))
        # dilated ModRes copies for the encoder (D only, vtoonify.py:200-207)
        if is_d:
            res = [L.AdaResBlock(ch[4], generator=g)]
            for i in range(3, 6):
                res += [L.AdaResBlock(ch[2 ** i], generator=g) for _ in range(2)]
            self.res = nn.ModuleList(res)


def init_vtoonify(cfg: VToonifyConfig, generator=None) -> VToonify:
    return VToonify(cfg, generator)


# res[1..6] dilations 4, 4, 2, 2, 1, 1 (vtoonify.py:204-207)
_ENCODER_DILATIONS = (None, 4, 4, 2, 2, 1, 1)


def prepare_styles(p: VToonify, cfg: VToonifyConfig, style):
    """Style prep half of forward (vtoonify.py:211-224). Returns
    (resstyles, adastyles): T_c-mapped styles for the encoder ModRes (D
    only; None for T) and per-layer generator styles (B, n_latent, 512) with
    T_s applied to layers >= 7 (D only)."""
    is_d = cfg.backbone == "dualstylegan"
    n_latent = cfg.n_latent
    resstyles = None
    if style.ndim < 3:
        if is_d:
            rs = D.color_transform(p.generator, style)
            resstyles = rs[:, None, :].expand(-1, n_latent, -1)
        adastyles = style[:, None, :].expand(-1, n_latent, -1)
    else:
        nb, nl, nd = style.shape
        if is_d:
            resstyles = D.color_transform(
                p.generator, style.reshape(nb * nl, nd)).reshape(nb, nl, nd)
        adastyles = style
    if is_d:
        cols = [adastyles[:, i] for i in range(n_latent)]
        for i in range(7, n_latent):
            cols[i] = L.equal_linear(p.generator.res[i], cols[i])
        adastyles = torch.stack(cols, dim=1)
    return resstyles, adastyles


def vtoonify_apply(p: VToonify, cfg: VToonifyConfig, x, style, d_s=None,
                   return_mask: bool = False, return_feat: bool = False):
    """reference model/vtoonify.py:210-277. x: (B, 3+19, H, W) NCHW in
    [-1, 1] RGB + parsing-logit channels, H and W multiples of 8; style:
    (B or 1, n_latent, 512) or (B, 512), or None with `return_feat`.
    Returns the (B, 3, 4H, 4W) image (for in_size -> out_size = 256 ->
    1024); with `return_feat` the encoder's (feat, skip) (the stage-1
    target); with `return_mask` (D backbone) (image, [m_E per fusion])."""
    is_d = cfg.backbone == "dualstylegan"
    if style is None and not return_feat:
        raise ValueError("vtoonify_apply: style=None needs return_feat")
    resstyles, adastyles = (None, None) if style is None else prepare_styles(
        p, cfg, style)

    # --- encoder walk, collecting multi-scale features
    enc = p.encoder
    feat = F.leaky_relu(L.conv2d_torch(enc.stem[0], x, padding=1), 0.2)
    feat = F.leaky_relu(L.conv2d_torch(enc.stem[1], feat, padding=1), 0.2)
    encoder_features = [feat]
    for blk in enc.down:
        feat = F.leaky_relu(L.conv2d_torch(blk[0], feat, stride=2, padding=1),
                            0.2)
        feat = F.leaky_relu(L.conv2d_torch(blk[1], feat, padding=1), 0.2)
        encoder_features.append(feat)
    encoder_features = encoder_features[::-1]

    for ii, rb in enumerate(enc.resblocks):
        feat = vtoonify_res_block(rb, feat)
        if is_d:
            feat = L.ada_res_block(p.res[ii + 1], feat, resstyles[:, ii + 1],
                                   d_s, dilation=_ENCODER_DILATIONS[ii + 1])

    out = feat
    skip = L.conv2d_torch(enc.final, feat)
    if return_feat:
        return out, skip

    # --- generator mid/high-res walk starting at 32x32 (convs[6::2])
    gp = p.generator.generator if is_d else p.generator
    start_pair = 3  # pair index producing 64px from 32px
    n_pairs = cfg.generator.log_size - 2
    _index = 1
    m_Es = []
    for pair in range(start_pair, n_pairs):
        if 2 ** (5 + (_index - 1) // 2) <= cfg.in_size:
            fusion_index = (_index - 1) // 2
            f_E = encoder_features[fusion_index]
            if is_d:
                out, m_E = fusion_apply(p.fusion_out[fusion_index], out, f_E, d_s)
                skip = L.conv2d_torch_cat2(p.fusion_skip[fusion_index], skip,
                                           f_E * m_E, padding=1)
                m_Es.append(m_E)
            else:
                out = L.conv2d_torch_cat2(p.fusion_out[fusion_index], out, f_E,
                                          padding=1)
                skip = L.conv2d_torch_cat2(p.fusion_skip[fusion_index], skip,
                                           f_E, padding=1)
        # noise is architecturally zero (vtoonify.py:266-267) -> omitted
        out = L.styled_conv(gp.convs[2 * pair], out, adastyles[:, _index + 6],
                            upsample=True)
        out = L.styled_conv(gp.convs[2 * pair + 1], out, adastyles[:, _index + 7])
        skip = L.to_rgb(gp.to_rgbs[pair], out, adastyles[:, _index + 8], skip)
        _index += 2
    if return_mask and is_d:
        return skip, m_Es
    return skip


def zplus2wplus(p: VToonify, cfg: VToonifyConfig, zplus):
    """vtoonify.py:285-286: z+ -> w+ through the frozen mapping MLP."""
    gp = p.generator.generator if cfg.backbone == "dualstylegan" else p.generator
    nb, nl, nd = zplus.shape
    return G.style_mlp(gp, cfg.generator,
                       zplus.reshape(nb * nl, nd)).reshape(zplus.shape)


# ---------------------------------------------------------------------------
# ConditionalDiscriminator (reference vtoonify.py:10-89)


@dataclass(frozen=True)
class CondDiscriminatorConfig:
    size: int = 256
    channel_multiplier: int = 2
    channel_max: int = 512
    use_condition: bool = False
    style_num: Optional[int] = None

    @property
    def base(self) -> G.DiscriminatorConfig:
        return G.DiscriminatorConfig(size=self.size,
                                     channel_multiplier=self.channel_multiplier,
                                     channel_max=self.channel_max)


class CondDiscriminator(G.Discriminator):
    def __init__(self, cfg: CondDiscriminatorConfig, generator=None):
        super().__init__(cfg.base, generator=generator)
        g = generator
        ch = cfg.base.channels
        if cfg.use_condition:
            cd = 128
            self.final_linear[1] = L.EqualLinear(ch[4], cd, generator=g)
            self.label_mapper = nn.ModuleList([
                L.LinearTorch(1, 64, generator=g),
                L.LinearTorch(64, 64, generator=g),
                L.LinearTorch(64, cd // 2, generator=g)])
            self.style_embed = L._param(
                torch.randn((cfg.style_num, cd - cd // 2), generator=g))


def init_cond_discriminator(cfg: CondDiscriminatorConfig,
                            generator=None) -> CondDiscriminator:
    return CondDiscriminator(cfg, generator)


def cond_discriminator_apply(p: CondDiscriminator, cfg: CondDiscriminatorConfig,
                             x, degree_label=None, style_ind=None):
    """(B, 3, size, size) -> (B, 1) logits; with `use_condition` the
    projection onto [label_mapper(degree_label), style_embed[style_ind]]."""
    h = L.equal_linear(p.final_linear[1], G.discriminator_features(p, x))
    if not cfg.use_condition:
        return h
    lab = degree_label
    for i, lp in enumerate(p.label_mapper):
        lab = L.linear_torch(lp, lab)
        if i < 2:
            lab = F.leaky_relu(lab, 0.2)
    cond = torch.cat([lab, p.style_embed[style_ind].to(lab.dtype)], dim=1)
    return torch.sum(h * cond, dim=1, keepdim=True) / math.sqrt(cond.shape[-1])
