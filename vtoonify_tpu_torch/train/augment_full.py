"""Full ADA augmentation: geometric (strong parameters) + colour transforms
+ the adaptive-p controller (port of vtoonify_tpu/train/augment_full.py:
`sample_affine_full`, `sample_color`, `apply_color`, `augment`,
`AdaptiveAugment`).

reference model/stylegan/non_leaking.py (the upstream stylegan2-ada
pipeline): stronger scales (sigma 0.2 log2), full +-pi rotations, then the
colour-matrix chain (brightness, contrast, luma flip, hue rotation,
saturation). The geometric step is `train/augment.py::random_apply_affine`,
whose warp runs in kernel B5 on the card (twice differentiable in the
image: R1 differentiates through it). NCHW. Random draws come from an
explicit `torch.Generator`, on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vtoonify_tpu_torch.train.augment import (
    _eye,
    _rotate_mat,
    _scale_mat,
    _translate_mat,
    random_apply_affine,
)

AXIS = (1 / math.sqrt(3),) * 3


def _draws(generator, size):
    dev = generator.device if generator is not None else None

    def rand():
        return torch.rand(size, generator=generator, device=dev)

    def randn():
        return torch.randn(size, generator=generator, device=dev)

    def coin():
        return torch.randint(0, 2, (size,), generator=generator, device=dev).float()

    return dev, rand, randn, coin


def sample_affine_full(generator, p, size, height, width):
    """non_leaking.py sample_affine (strong parameters): (size, 3, 3)
    float32 forward affines."""
    dev, rand, randn, coin = _draws(generator, size)

    def apply(prob, transform, prev):
        sel = (rand() < prob).float()[:, None, None]
        return (sel * transform + (1 - sel) * _eye(size, dev)) @ prev

    G = _eye(size, dev)
    f = coin()
    G = apply(p, _scale_mat(1 - 2.0 * f, torch.ones(size, device=dev)), G)  # flip
    t = rand() * 0.25 - 0.125                                               # int translate
    G = apply(p, _translate_mat(torch.round(t * width) / width,
                                torch.round(t * height) / height), G)
    s = torch.exp(randn() * (0.2 * math.log(2)))                            # iso scale
    G = apply(p, _scale_mat(s, s), G)
    p_rot = 1 - math.sqrt(1 - p)
    th = rand() * (2 * math.pi) - math.pi                                   # pre-rotate
    G = apply(p_rot, _rotate_mat(-th), G)
    s = torch.exp(randn() * (0.2 * math.log(2)))                            # aniso scale
    G = apply(p, _scale_mat(s, 1 / s), G)
    th = rand() * (2 * math.pi) - math.pi                                   # post-rotate
    G = apply(p_rot, _rotate_mat(-th), G)
    t = randn() * 0.125                                                     # frac translate
    return apply(p, _translate_mat(t, t), G)


# --- colour matrices (non_leaking.py:100-160, 252-283) ----------------------


def _eye4(b, device):
    return torch.eye(4, device=device).repeat(b, 1, 1)


def _translate3d(t):
    m = _eye4(t.shape[0], t.device)
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3] = t, t, t
    return m


def _scale3d(s):
    m = _eye4(s.shape[0], s.device)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = s, s, s
    return m


def _axis4(device):
    return torch.tensor(AXIS + (0.0,), device=device)


def _luma_flip(i):
    axis = _axis4(i.device)
    flip = 2 * torch.outer(axis, axis)[None] * i[:, None, None]
    return torch.eye(4, device=i.device)[None] - flip


def _hue_rotate(theta):
    a = AXIS[0]
    u = torch.tensor(AXIS, device=theta.device)
    cross = torch.tensor([[0, -a, a], [a, 0, -a], [-a, a, 0]], device=theta.device)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    rot = (c * torch.eye(3, device=theta.device)[None] + s * cross[None]
           + (1 - c) * torch.outer(u, u)[None])
    out = _eye4(theta.shape[0], theta.device)
    out[:, :3, :3] = rot
    return out


def _saturation(i):
    axis = _axis4(i.device)
    a = torch.outer(axis, axis)[None]
    return a + (torch.eye(4, device=i.device)[None] - a) * i[:, None, None]


def sample_color(generator, p, size):
    """non_leaking.py colour chain: (size, 4, 4) float32 matrices."""
    dev, rand, randn, coin = _draws(generator, size)

    def apply(prob, transform, prev):
        sel = (rand() < prob).float()[:, None, None]
        return (sel * transform + (1 - sel) * _eye4(size, dev)) @ prev

    C = _eye4(size, dev)
    C = apply(p, _translate3d(randn() * 0.2), C)                           # brightness
    C = apply(p, _scale3d(torch.exp(randn() * (0.5 * math.log(2)))), C)    # contrast
    C = apply(p, _luma_flip(coin()), C)
    C = apply(p, _hue_rotate(rand() * (2 * math.pi) - math.pi), C)
    return apply(p, _saturation(torch.exp(randn() * math.log(2))), C)


def apply_color(img, mat):
    """img (B, 3, H, W); mat (B, 4, 4) (non_leaking.py:444-452):
    out = M[:3, :3] img + M[:3, 3] per pixel."""
    mul = mat[:, :3, :3].to(img.device, img.dtype)
    add = mat[:, :3, 3].to(img.device, img.dtype)[:, :, None, None]
    return torch.einsum("bchw,bdc->bdhw", img, mul) + add


def augment(img, p, generator=None, max_pad=None, G=None, C=None):
    """Full ADA (non_leaking.py:455-460): the affine, then the colour
    transform. `G` (the INVERSE affine, as returned) and `C` skip their
    draws. Returns (augmented, (G, C))."""
    b, _, h, w = img.shape
    if G is None:
        G = torch.linalg.inv(sample_affine_full(generator, p, b, h, w))
    img, G = random_apply_affine(img, p, G=G, max_pad=max_pad)
    if C is None:
        C = sample_color(generator, p, b)
    return apply_color(img, C), (G, C)


class AdaptiveAugment:
    """Adaptive p-controller (non_leaking.py:15-48): tracks sign(D(real))
    and walks p toward the target r_t every `update_every` calls. Host-side
    state; `tune` reads the real predictions back to the host."""

    def __init__(self, ada_aug_target=0.6, ada_aug_len=500 * 1000,
                 update_every=256):
        self.ada_aug_target = ada_aug_target
        self.ada_aug_len = ada_aug_len
        self.update_every = update_every
        self.ada_update = 0
        self.sign_sum = 0.0
        self.n_pred = 0.0
        self.r_t_stat = 0.0
        self.ada_aug_p = 0.0

    def tune(self, real_pred) -> float:
        if isinstance(real_pred, torch.Tensor):
            real_pred = real_pred.detach().float().cpu().numpy()
        rp = np.asarray(real_pred)
        self.sign_sum += float(np.sign(rp).sum())
        self.n_pred += rp.shape[0]
        self.ada_update += 1
        if self.ada_update % self.update_every == 0:
            self.r_t_stat = self.sign_sum / max(self.n_pred, 1)
            sign = 1 if self.r_t_stat > self.ada_aug_target else -1
            self.ada_aug_p += sign * self.n_pred / self.ada_aug_len
            self.ada_aug_p = min(1.0, max(0.0, self.ada_aug_p))
            self.sign_sum = 0.0
            self.n_pred = 0.0
            self.ada_update = 0
        return self.ada_aug_p
