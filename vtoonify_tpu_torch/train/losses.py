"""GAN, regulariser and reconstruction losses (port of
vtoonify_tpu/train/losses.py: `d_logistic_loss`, `g_nonsaturating_loss`,
`d_r1_loss`, `g_path_regularize`, `make_noise` as `make_z_noise`,
`mixing_noise`, `mse_loss`, `mask_loss`; reference util.py:49-127).

The two regularisers differentiate a gradient: they take the network as a
callable and build the inner gradient with `create_graph=True`, so their
penalty's backward runs through the kernels' double backwards
(ops/kernels.py). Random draws come from an explicit `torch.Generator`.
Under a process group every loss is held to the global batch's: the means
over the batch are the ranks' means averaged with the gradients, and the
batch statistics inside a nonlinearity (`mask_loss`, the path length's
mean) are averaged over the ranks first. Those averages are collectives:
under a group of more than one rank, every rank calls `mask_loss` and
`g_path_regularize` together, or the lone caller blocks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vtoonify_tpu_torch.parallel import collectives as C


def d_logistic_loss(real_pred, fake_pred):
    """reference util.py:68-72."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    """reference util.py:85-88."""
    return F.softplus(-fake_pred).mean()


def d_r1_loss(d_fn, real_img):
    """reference util.py:75-82: the mean over the batch of |grad_x
    sum(d_fn(x))|^2 at x = real_img. `d_fn` maps images to logits (a
    discriminator, or the augment followed by one); the gradient keeps its
    graph, so the penalty's backward reaches d_fn's parameters."""
    x = real_img.detach().requires_grad_()
    (grad,) = torch.autograd.grad(d_fn(x).sum(), x, create_graph=True)
    return grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean()


def g_path_regularize(g_fn, latents, mean_path_length, generator=None,
                      decay: float = 0.01, noise=None):
    """StyleGAN2 path-length regulariser (reference util.py:91-108).

    `g_fn` maps (B, n_latent, D) latents to (B, C, H, W) images. The
    gradient of sum(g_fn(latents) * noise) w.r.t. the latents keeps its
    graph: a `latents` that carries history (the mapping network's output)
    passes the penalty's gradient on to it. `noise` defaults to a standard
    normal draw from `generator` (on the image's device) over sqrt(H W).
    Returns (penalty, new mean path length (detached), path_lengths (B,)).
    """
    if not latents.requires_grad:
        latents = latents.detach().requires_grad_()
    img = g_fn(latents)
    if noise is None:
        noise = torch.randn(img.shape, generator=generator,
                            device=generator.device if generator is not None
                            else img.device).to(img.device, img.dtype)
        noise = noise / math.sqrt(img.shape[2] * img.shape[3])
    (grad,) = torch.autograd.grad((img * noise).sum(), latents, create_graph=True)
    path_lengths = grad.square().sum(dim=2).mean(dim=1).sqrt()
    # the mean over the global batch under a process group (equal shares)
    path_mean = mean_path_length + decay * (
        C.mean_over_ranks(path_lengths.mean()) - mean_path_length)
    penalty = (path_lengths - path_mean).square().mean()
    return penalty, path_mean.detach(), path_lengths


def make_z_noise(generator, batch: int, latent_dim: int, n_noise: int,
                 device=None):
    """reference util.py:111-118 (the JAX package's losses.make_noise; not
    models.generator.make_noise, the per-layer noise maps): one standard
    normal (B, D) z from `generator` (on its device, then moved to
    `device`), or a list of `n_noise` of them."""
    gdev = generator.device if generator is not None else device
    z = torch.randn((n_noise, batch, latent_dim), generator=generator,
                    device=gdev).to(device)
    return z[0] if n_noise == 1 else list(z.unbind(0))


def mixing_noise(generator, batch: int, latent_dim: int, prob: float,
                 device=None):
    """reference util.py:121-126: with probability `prob` two z for style
    mixing, else one, as a list. The branch is a uniform draw from
    `generator` read on the host (the reference's random.random())."""
    gdev = generator.device if generator is not None else device
    if prob > 0 and float(torch.rand((), generator=generator, device=gdev)) < prob:
        return make_z_noise(generator, batch, latent_dim, 2, device)
    return [make_z_noise(generator, batch, latent_dim, 1, device)]


def mse_loss(a, b):
    return (a - b).square().mean()


def mask_loss(m_Es, d_s, weight):
    """L_msk (reference train_vtoonify_d.py:315-319). Each mask's mean is
    over the global batch under a process group (a nonlinear function of a
    batch statistic: the mean of the ranks' means, each over an equal
    share)."""
    gd_s = (1 - d_s) ** 2 * 0.9 + 0.1
    total = 0.0
    for m_E in m_Es:
        total = total + torch.relu(C.mean_over_ranks(m_E.mean()) - gd_s) * weight
    return total
