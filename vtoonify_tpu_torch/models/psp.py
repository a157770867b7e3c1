"""The full pSp: encoder + StyleGAN2 decoder (port of
vtoonify_tpu/models/psp.py: `PSPConfig`, `init_psp`, `psp_apply`;
`convert_psp` is convert/torch_import.py::convert_psp).

reference model/encoder/psp.py:20-125: encode -> latent_avg centring ->
optional latent masking / injection / alpha mixing -> decode, with z+ / w+
switching and 256 px face pooling. The encoder is models/psp_encoder.py
(plain PyTorch); the decoder is models/generator.py, whose styled convs run
in kernels B1 (3x3, polyphase up), B2, B3 (ToRGB skip) and B4.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models.psp_encoder import (
    PSPEncoderConfig,
    init_psp_encoder,
    psp_encoder_apply,
)
from vtoonify_tpu_torch.ops.interp import avg_pool


@dataclass(frozen=True)
class PSPConfig:
    output_size: int = 1024
    start_from_latent_avg: bool = True

    @property
    def n_styles(self) -> int:
        return int(math.log2(self.output_size)) * 2 - 2

    @property
    def encoder(self) -> PSPEncoderConfig:
        return PSPEncoderConfig(n_styles=self.n_styles)

    @property
    def decoder(self) -> G.GeneratorConfig:
        return G.GeneratorConfig(size=self.output_size)


class PSP(nn.Module):
    def __init__(self, cfg: PSPConfig, generator=None):
        super().__init__()
        self.encoder = init_psp_encoder(cfg.encoder, generator)
        self.decoder = G.init_generator(cfg.decoder, generator)
        self.register_buffer("latent_avg", torch.zeros((cfg.n_styles, 512)))


def init_psp(cfg: PSPConfig, generator=None) -> PSP:
    return PSP(cfg, generator)


def psp_apply(p: PSP, cfg: PSPConfig, x, *, resize: bool = True,
              latent_mask: Optional[Sequence[int]] = None, inject_latent=None,
              alpha: Optional[float] = None, input_code: bool = False,
              noise=None, z_plus_latent: bool = False,
              return_latents: bool = False):
    """x: (B, 3, H, W) faces in [-1, 1], or (B, n_styles, 512) codes with
    `input_code`. Returns the (B, 3, S, S) images (S = output_size, or 256
    with `resize`), and the codes with `return_latents`. `noise`: the
    decoder's per-layer maps, or None for none."""
    if input_code:
        codes = x
    else:
        codes = psp_encoder_apply(p.encoder, cfg.encoder, x)
        if cfg.start_from_latent_avg:
            codes = codes + p.latent_avg.to(codes.dtype)[None]

    if latent_mask is not None:
        cols = list(codes.unbind(1))
        for i in latent_mask:
            if inject_latent is None:
                cols[i] = torch.zeros_like(cols[i])
            elif alpha is not None:
                cols[i] = alpha * inject_latent[:, i] + (1 - alpha) * cols[i]
            else:
                cols[i] = inject_latent[:, i]
        codes = torch.stack(cols, dim=1)

    # codes given as input go through the mapping network row by row (the
    # JAX style MLP maps the last axis): the z+ walk
    images = G.generate(p.decoder, cfg.decoder, [codes],
                        input_is_latent=not input_code and not z_plus_latent,
                        z_plus_latent=z_plus_latent or (input_code and codes.ndim == 3),
                        noise=noise)
    if resize:
        images = avg_pool(images, cfg.output_size // 256)
    return (images, codes) if return_latents else images
