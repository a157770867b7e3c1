"""GAN and reconstruction losses of the stage-2 step (port of
vtoonify_tpu/train/losses.py: `d_logistic_loss`, `g_nonsaturating_loss`,
`mse_loss`, `mask_loss`; reference util.py:49-127)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def d_logistic_loss(real_pred, fake_pred):
    """reference util.py:68-72."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    """reference util.py:85-88."""
    return F.softplus(-fake_pred).mean()


def mse_loss(a, b):
    return (a - b).square().mean()


def mask_loss(m_Es, d_s, weight):
    """L_msk (reference train_vtoonify_d.py:315-319)."""
    gd_s = (1 - d_s) ** 2 * 0.9 + 0.1
    total = 0.0
    for m_E in m_Es:
        total = total + torch.relu(m_E.mean() - gd_s) * weight
    return total
