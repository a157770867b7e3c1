"""Exponential moving average of parameters (port of
vtoonify_tpu/train/ema.py: `EMA_DECAY`, `ema_update`; reference util.py:54-59
`accumulate`, decay 0.5**(32/10000) ~ 0.99778, train_vtoonify_d.py:95,210).
The update is in place, under no_grad."""

from __future__ import annotations

import torch

EMA_DECAY = 0.5 ** (32 / (10 * 1000))


@torch.no_grad()
def ema_update(ema, module, decay: float = EMA_DECAY):
    """ema <- ema * decay + module * (1 - decay), parameter by parameter
    (the two modules have the same structure)."""
    for e, p in zip(ema.parameters(), module.parameters(), strict=True):
        e.copy_(e * decay + p * (1.0 - decay))
    return ema
