"""A run's inputs, made from its seed on one device: the frame pool and the
per-video style code. The same seed gives the same inputs; every seed gives
the same sizes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.seeds import derive_seed
from gpubench.weights import log2i

# the harness samples the outputs it checks on seeds.STREAM_SAMPLE (4)
STREAM_VT, STREAM_BISENET, STREAM_STYLE, STREAM_FRAMES = range(4)


def frame_pool(seed: int, n: int, h: int, w: int, device) -> torch.Tensor:
    """n distinct uint8 (h, w, 3) frames, (n, h, w, 3) on `device`: each a
    smooth random image (a 24 x 24 grid of random colours, bilinear to the
    frame) with pixel noise of +-12."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, STREAM_FRAMES))
    grid = torch.randint(0, 256, (n, 3, 24, 24), generator=gen, device=device).float()
    base = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False)
    noise = torch.randint(-12, 13, (n, 3, h, w), generator=gen, device=device).float()
    return (base + noise).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def style_code(seed: int, vt_cfg: dict, device) -> torch.Tensor:
    """The per-video W+ code (1, n_latent, 512), float32, as compute_style
    hands it on: N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, STREAM_STYLE))
    n_latent = log2i(vt_cfg["out_size"]) * 2 - 2
    return torch.randn((1, n_latent, vt_cfg["style_channels"]), generator=gen, device=device)
