"""Geometric augmentation of the stage-2 training pairs (port of
vtoonify_tpu/train/augment.py: `SYM6`, `sample_affine`, `_affine_grid`,
`_pixel_affine_coefs`, `_affine_warp`, `random_apply_affine`).

reference model/simple_augment.py:391-441 with its mild parameters: reflect
pad -> 2x SYM6 wavelet upsample -> affine bilinear warp -> 2x SYM6 wavelet
downsample. As in the JAX package the reflect pad is static (`max_pad`,
default W/2 + 6), so the output equals the reference's whenever its
data-dependent pad would have fit. NCHW. The wavelet passes run in kernel B3
(12-tap per-axis filters); the warp runs in kernel B5 on every CUDA call
(no size gate, no fallback), its gradient being the F.grid_sample VJP.
Random draws come from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vtoonify_tpu_torch.ops import kernels
from vtoonify_tpu_torch.ops.upfirdn2d import upfirdn2d

SYM6 = torch.tensor((
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
), dtype=torch.float32)


def _eye(b, device):
    return torch.eye(3, device=device).repeat(b, 1, 1)


def _translate_mat(tx, ty):
    m = _eye(tx.shape[0], tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _rotate_mat(theta):
    m = _eye(theta.shape[0], theta.device)
    c, s = torch.cos(theta), torch.sin(theta)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def _scale_mat(sx, sy):
    m = _eye(sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def _scale_single(sx, sy, device=None):
    return torch.tensor([[sx, 0, 0], [0, sy, 0], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def _translate_single(tx, ty, device=None):
    return torch.tensor([[1, 0, tx], [0, 1, ty], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def sample_affine(generator, p, size, height, width):
    """reference simple_augment.py:196-252 (mild parameters): (size, 3, 3)
    float32 forward affines, drawn from `generator` on its device."""
    dev = generator.device

    def rand():
        return torch.rand(size, generator=generator, device=dev)

    def randn():
        return torch.randn(size, generator=generator, device=dev)

    def apply(prob, transform, prev):
        sel = (rand() < prob).float()[:, None, None]
        return (sel * transform + (1 - sel) * _eye(size, dev)) @ prev

    G = _eye(size, dev)
    f = torch.randint(0, 2, (size,), generator=generator, device=dev).float()
    G = apply(p, _scale_mat(1 - 2.0 * f, torch.ones(size, device=dev)), G)  # flip
    t = rand() * 0.25 - 0.125                                               # int translate
    G = apply(p, _translate_mat(torch.round(t * width) / width,
                                torch.round(t * height) / height), G)
    s = torch.exp(randn() * (0.1 * math.log(2)))                            # iso scale
    G = apply(p, _scale_mat(s, s), G)
    p_rot = 1 - math.sqrt(1 - p)
    th = rand() * (math.pi * 0.5) - math.pi * 0.25                          # pre-rotate
    G = apply(p_rot, _rotate_mat(-th), G)
    s = torch.exp(randn() * (0.1 * math.log(2)))                            # aniso scale
    G = apply(p, _scale_mat(s, 1 / s), G)
    th = rand() * (math.pi * 0.5) - math.pi * 0.25                          # post-rotate
    G = apply(p_rot, _rotate_mat(-th), G)
    t = randn() * 0.125                                                     # frac translate
    return apply(p, _translate_mat(t, t), G)


def _affine_grid(theta, hw, align_corners=False):
    """F.affine_grid on (N, 2, 3) theta -> (N, H, W, 2), float32."""
    h, w = hw
    return F.affine_grid(theta.float(), (theta.shape[0], 1, h, w),
                         align_corners=align_corners)


def _pixel_affine_coefs(theta, out_hw, in_hw):
    """Normalized-grid affine (N, 2, 3) -> pixel-space coefficients (N, 6)
    [ax, bx, cx, ay, by, cy]: `_affine_grid` (align_corners=False) composed
    with grid_sample's coordinate unnormalization."""
    ho, wo = out_hw
    h, w = in_hw
    t00, t01, t02 = theta[:, 0, 0], theta[:, 0, 1], theta[:, 0, 2]
    t10, t11, t12 = theta[:, 1, 0], theta[:, 1, 1], theta[:, 1, 2]
    ax = t00 * (w / wo)
    bx = t01 * (w / ho)
    cx = (t00 * (1 / wo - 1) + t01 * (1 / ho - 1) + t02 + 1) * (w / 2) - 0.5
    ay = t10 * (h / wo)
    by = t11 * (h / ho)
    cy = (t10 * (1 / wo - 1) + t11 * (1 / ho - 1) + t12 + 1) * (h / 2) - 0.5
    return torch.stack([ax, bx, cx, ay, by, cy], dim=-1)


def _affine_warp(img, theta, out_hw):
    """grid_sample(affine grid), zeros padding: kernel B5 on the card, its
    plain version (F.grid_sample) on the CPU; coordinates stay float32
    whatever the image dtype."""
    coef = _pixel_affine_coefs(theta.float(), out_hw, img.shape[2:])
    return kernels.affine_warp(img, coef.to(img.device), out_hw)


def warp_theta(G_inv, hw, hw2x, pad_k: int = SYM6.shape[0] // 4):
    """The warp step of `random_apply_affine`: the inverse affine G_inv
    (B, 3, 3) of an (h, w) image, carried onto its x2-upsampled padded
    copy (h2x, w2x) -> (theta (B, 2, 3) in normalized coordinates, the
    warp's output size (2 (h + 2 pad_k), 2 (w + 2 pad_k)))."""
    (h, w), (h2x, w2x) = hw, hw2x
    dev = G_inv.device
    G_inv = _scale_single(2, 2, dev) @ G_inv @ _scale_single(0.5, 0.5, dev)
    G_inv = (_translate_single(-0.5, -0.5, dev) @ G_inv
             @ _translate_single(0.5, 0.5, dev))
    out_h, out_w = (h + pad_k * 2) * 2, (w + pad_k * 2) * 2
    G_inv = (_scale_single(2 / w2x, 2 / h2x, dev) @ G_inv
             @ _scale_single(1 / (2 / out_w), 1 / (2 / out_h), dev))
    return G_inv[:, :2, :], (out_h, out_w)


def random_apply_affine(img, p, generator=None, G=None, max_pad=None):
    """img: (B, C, H, W). Returns (augmented, G): `G` is the INVERSE affine
    (the reference's returned matrix); pass it to skip the sampling."""
    b, c, h, w = img.shape
    # taps round through the image dtype on the host (B3 takes CPU float32
    # taps, by value)
    k = SYM6.to(img.dtype).float()
    len_k = k.shape[0]
    pad_k = len_k // 4
    if G is None:
        G = torch.linalg.inv(sample_affine(generator, p, b, h, w))
    G_inv = G.float().to(img.device)
    if max_pad is None:
        max_pad = w // 2 + 2 * pad_k
    pad = int(max_pad)
    img_pad = F.pad(img, [pad] * 4, mode="reflect")

    # symmetric static pad: the reference's (pad1-pad2)/2 recentering is 0
    up_pad = ((len_k + 1) // 2, (len_k - 2) // 2)
    img_2x = upfirdn2d(img_pad, k[None, :], up=(2, 1), pad=(*up_pad, 0, 0))
    img_2x = upfirdn2d(img_2x, k[:, None], up=(1, 2), pad=(0, 0, *up_pad))

    theta, out_hw = warp_theta(G_inv, (h, w), img_2x.shape[2:])
    img_affine = _affine_warp(img_2x, theta, out_hw)

    k_flip = torch.flip(k, (0,))
    d_p = -pad_k * 2
    down_pad = (d_p + (len_k - 1) // 2, d_p + (len_k - 2) // 2)
    img_down = upfirdn2d(img_affine, k_flip[None, :], down=(2, 1),
                         pad=(*down_pad, 0, 0))
    img_down = upfirdn2d(img_down, k_flip[:, None], down=(1, 2),
                         pad=(0, 0, *down_pad))
    return img_down, G
