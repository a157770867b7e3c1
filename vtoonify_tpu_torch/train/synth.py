"""Synthetic teacher data for both training stages of VToonify-D and
VToonify-T (port of vtoonify_tpu/train/synth.py: `down`,
`sample_content_w_batch`, `stylegan_image`, `parsing_input`,
`synth_pretrain_batch`, `synth_train_batch`, `synth_pretrain_t_batch`,
`synth_train_t_batch`).

reference train_vtoonify_d.py:120-137 / :238-276 and train_vtoonify_t.py:
105-119 / :193-218: random w latents plus editing directions through the
frozen StyleGAN / DualStyleGAN teachers make (content, stylized-target)
pairs (stage 2) or (content, encoder-feature target) pairs (stage 1), with
anti-aliased downsampling, BiSeNet parsing-map inputs and, in stage 2, joint
geometric augmentation. Every random value comes in a draws object
(`PretrainDraws`, `TrainDDraws`, `TrainTDraws` in train/steps.py), so one
step's data can be replayed. The caller runs this under `torch.no_grad()`;
the working dtype follows the teacher's parameters (bf16 synthesis casts
them).
"""

from __future__ import annotations

import torch

from vtoonify_tpu_torch.models import dualstylegan as D
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models.bisenet import bisenet_apply
from vtoonify_tpu_torch.models.psp_encoder import psp_encoder_apply
from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig, zplus2wplus
from vtoonify_tpu_torch.ops.interp import avg_pool, resize_bilinear
from vtoonify_tpu_torch.ops.upfirdn2d import downsample_2x, make_kernel
from vtoonify_tpu_torch.train.augment import random_apply_affine

BLUR_1D = make_kernel((1.0, 3.0, 3.0, 1.0))
PARSING_WEIGHT = 1.0 / 16.0


def down(x):
    """reference Downsample(kernel=[1,3,3,1], factor=2)
    (train_vtoonify_d.py:469), in kernel B3."""
    return downsample_2x(x, BLUR_1D.to(x.dtype).float())  # host taps, rounded


def sample_content_w_batch(gen_p, gcfg: G.GeneratorConfig, directions, z,
                           dir_idx):
    """w' = repeat_n(MLP(z)) with editing noise directions[dir_idx] on
    layers 3:7 (train_vtoonify_d.py:122-124, 239-241). z (B, style_dim) and
    dir_idx (B,) are the step's draws."""
    w = G.style_mlp(gen_p, gcfg, z.to(gen_p.input.dtype))
    ws = w[:, None, :].repeat(1, gcfg.n_latent, 1)
    ws[:, 3:7] = ws[:, 3:7] + directions[dir_idx, 3:7]
    return ws


def stylegan_image(gen_p, gcfg, ws, noise):
    """x'' = clamp(G0(0.5 w'), -1, 1) with the given per-layer noise."""
    noise = [n.to(ws.dtype) for n in noise]
    img = G.generate(gen_p, gcfg, [0.5 * ws], input_is_latent=True, noise=noise)
    return torch.clamp(img, -1.0, 1.0)


def parsing_input(parsing, img512):
    """mask512 = BiSeNet(2 clamp(x512)) (train_vtoonify_d.py:129-130)."""
    return bisenet_apply(parsing, 2.0 * torch.clamp(img512, -1.0, 1.0))


def _content_input(parsing, img_gen):
    """real_input = [x''_256, BiSeNet(x''_512)_256 / 16] of a generated
    content image (train_vtoonify_d.py:126-131)."""
    img512 = down(img_gen)
    img256 = down(img512)
    mask512 = parsing_input(parsing, img512)
    return torch.cat([img256, down(mask512) * PARSING_WEIGHT], dim=1)


def synth_pretrain_batch(draws, vt, cfg: VToonifyConfig, parsing, directions,
                         style, d_s):
    """One stage-1 iteration's teacher data (train_vtoonify_d.py:120-137):
    real_input (B, 22, in, in), and the DualStyleGAN's features after the
    ModRes region at every layer weight `d_s` (real_feat, real_skip)."""
    ds = vt.generator
    gen = ds.generator
    gcfg = cfg.generator
    ws = sample_content_w_batch(gen, gcfg, directions, draws.z, draws.dir_idx)
    real_input = _content_input(
        parsing, stylegan_image(gen, gcfg, ws, draws.noise_content))
    noise = [n.to(ws.dtype) for n in draws.noise_feat]
    real_feat, real_skip = D.dualstylegan_apply(
        ds, cfg.dualstylegan, [0.5 * ws], style, input_is_latent=True,
        noise=noise, use_res=True, interp_weights=[d_s] * cfg.n_latent,
        return_feat=True)
    return {"real_input": real_input, "real_feat": real_feat,
            "real_skip": real_skip}


def _augmented_pair(xc, xs, parsing, affine, aug_p, aug_max_pad):
    """The stage-2 pair after the joint augment (train_vtoonify_d.py:
    262-275): the student's input at in_size and 1024 px (with the parsing
    map), and the target."""
    imgs, _ = random_apply_affine(torch.cat([xc, xs], dim=1), aug_p,
                                  G=affine, max_pad=aug_max_pad)
    real_input1024 = imgs[:, 0:3].contiguous()  # B3 takes contiguous planes
    real_output = imgs[:, 3:6]
    real_input512 = down(real_input1024)
    real_input256 = down(real_input512)
    mask512 = parsing_input(parsing, real_input512)
    mask256 = down(mask512)
    mask1024 = mask512.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return {
        "real_input": torch.cat([real_input256, mask256 * PARSING_WEIGHT], dim=1),
        "real_input1024": real_input1024,
        "mask1024": mask1024,
        "real_output": real_output,
    }


def _psp_input(xc):
    """adaptive_avg_pool2d(xc, 256) (train_vtoonify_d.py:248); configs below
    256 px upsample so pSp still sees 256 px."""
    return (avg_pool(xc, xc.shape[2] // 256) if xc.shape[2] >= 256
            else resize_bilinear(xc, (256, 256)))


def synth_train_batch(draws, vt, cfg: VToonifyConfig, parsing, psp, psp_cfg,
                      latent_avg, directions, style, d_s, weights, wc_prev,
                      color_fuse_t, use_color_jitter: bool, xl_override=None,
                      aug_p: float = 0.2, aug_max_pad=None):
    """One stage-2 iteration's paired data (train_vtoonify_d.py:238-276).

    Returns a dict with real_input (B, 22, in, in), real_input1024,
    mask1024, real_output, xl (w''), wc (the next iteration's color-jitter
    carry). `use_color_jitter` is a Python bool."""
    ds = vt.generator
    gen = ds.generator
    gcfg = cfg.generator

    wc = sample_content_w_batch(gen, gcfg, directions, draws.z, draws.dir_idx)
    xc = stylegan_image(gen, gcfg, wc, draws.noise_xc)

    if xl_override is not None:
        xl = xl_override  # fix_style & not fix_color: that style's color
    else:
        xl_w = zplus2wplus(vt, cfg, psp_encoder_apply(psp, psp_cfg, _psp_input(xc),
                                                      latent_avg=latent_avg))
        xl = torch.cat([style[:, 0:7], xl_w[:, 7:18]], dim=1)

    noise = [n.to(wc.dtype) for n in draws.noise_xs]
    xs = D.dualstylegan_apply(ds, cfg.dualstylegan, [0.5 * wc], xl,
                              input_is_latent=True, noise=noise, use_res=True,
                              interp_weights=list(weights))
    xs = torch.clamp(xs, -1.0, 1.0)

    if use_color_jitter:  # fuse wc[7:] with the previous iteration's (ramped)
        wcf = wc.clone()
        wcf[:, 7:] = (wc_prev[:, 7:] * (color_fuse_t - 1.0)
                      + wc[:, 7:] * (2.0 - color_fuse_t))
        xc = stylegan_image(gen, gcfg, wcf, draws.noise_jitter)

    return {**_augmented_pair(xc, xs, parsing, draws.affine, aug_p, aug_max_pad),
            "xl": xl, "wc": wc}


# ---------------------------------------------------------------------------
# VToonify-T (reference train_vtoonify_t.py)


def synth_pretrain_t_batch(draws, base, gcfg: G.GeneratorConfig, vt,
                           cfg: VToonifyConfig, parsing, directions):
    """T stage-1 teacher data (train_vtoonify_t.py:105-119): the content from
    the un-blended base G0 (`base`), the feature targets from the blended G1
    (`vt.generator`) through the return_feature_ind=6 early exit."""
    ws = sample_content_w_batch(base, gcfg, directions, draws.z, draws.dir_idx)
    real_input = _content_input(
        parsing, stylegan_image(base, gcfg, ws, draws.noise_content))
    noise = [n.to(ws.dtype) for n in draws.noise_feat]
    real_feat, real_skip = G.generator_apply(vt.generator, gcfg, 0.5 * ws,
                                             noise=noise, return_feature_ind=6)
    return {"real_input": real_input, "real_feat": real_feat,
            "real_skip": real_skip}


def synth_train_t_batch(draws, base, gcfg: G.GeneratorConfig, vt,
                        cfg: VToonifyConfig, parsing, psp, psp_cfg, latent_avg,
                        directions, aug_p: float = 0.2, aug_max_pad=None):
    """T stage-2 pair (train_vtoonify_t.py:193-218): xl = [0.5 w'[:7], the
    pSp code mapped through base G0's MLP [7:]]; y' from the blended G1
    with no further truncation; then the joint augment. Returns the keys of
    `synth_train_batch` but `wc`."""
    wc = sample_content_w_batch(base, gcfg, directions, draws.z, draws.dir_idx)
    xc = stylegan_image(base, gcfg, wc, draws.noise_xc)
    xl_zp = psp_encoder_apply(psp, psp_cfg, _psp_input(xc), latent_avg=latent_avg)
    nb, nl, nd = xl_zp.shape
    xl_w = G.style_mlp(base, gcfg, xl_zp.reshape(nb * nl, nd)).reshape(nb, nl, nd)
    xl = torch.cat([wc[:, 0:7] * 0.5, xl_w[:, 7:18]], dim=1)
    noise = [n.to(wc.dtype) for n in draws.noise_xs]
    xs = torch.clamp(G.generate(vt.generator, gcfg, [xl], input_is_latent=True,
                                noise=noise), -1.0, 1.0)
    return {**_augmented_pair(xc, xs, parsing, draws.affine, aug_p, aug_max_pad),
            "xl": xl}
