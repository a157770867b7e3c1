"""VToonify-T trainer CLI — option parity with reference
train_vtoonify_t.py:37-75 (port of vtoonify_tpu/cli/train_t.py): a
layer-wise blend of a style-finetuned StyleGAN (low) and the FFHQ base
(high) makes the frozen G1, then encoder distillation (--pretrain) and full
training with an unconditional discriminator.

Usage (the card; add --cpu for the CPU):
  python -m vtoonify_tpu_torch.cli.train_t --pretrain --name vtoonify_t_cartoon
  python -m vtoonify_tpu_torch.cli.train_t --name vtoonify_t_cartoon --export_pt

Writes checkpoint/NAME/{pretrain.ckpt, pretrain_state.ckpt, vtoonify.ckpt,
train_state.ckpt} and, with --export_pt, reference-format .pt files; logs
go to log/NAME/. Several cards: one process each, as cli/train_d.py says.
--tp k splits the wide weights of G0 and the frozen G1 (both stages) and of
the student and the discriminator (stage 2) over k cards a rank, as
cli/train_d.py says.
"""

from __future__ import annotations

import argparse
import os

import torch

from vtoonify_tpu_torch.cli import _train_loop as TL

# per-style blend-weight recipes (reference train_vtoonify_t.py:30-35)
STYLE_BLEND_WEIGHTS = {
    "cartoon": [0.75] * 7 + [1] * 11,
    "caricature": [0.75] * 7 + [1] * 11,
    "arcane": [0.75] * 7 + [1] * 11,
    "comic": [1] * 7 + [1] * 11,
    "pixar": [1] * 7 + [1] * 11,
    "illustration": [0.5] * 7 + [1] * 11,
}


def build_parser():
    p = argparse.ArgumentParser(description="Train VToonify-T (PyTorch + CUDA)")
    TL.add_common_args(p, "train_vtoonify_t.py:44")
    p.add_argument("--stylegan_path", type=str,
                   default="./checkpoint/stylegan2-ffhq-config-f.pt",
                   help="FFHQ base StyleGAN (G0)")
    p.add_argument("--finetunegan_path", type=str,
                   default="./checkpoint/cartoon/finetune-000600.pt",
                   help="style-finetuned StyleGAN")
    p.add_argument("--weight", type=float, nargs="+",
                   default=[1] * 7 + [0] * 11,
                   help="layer-wise blending weights (18 at the production "
                        "1024px config — reference train_vtoonify_t.py:59; "
                        "n_latent entries generally, truncated if longer)")
    p.add_argument("--name", type=str, default="vtoonify_t_cartoon")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = TL.start(args)

    from vtoonify_tpu_torch.convert.torch_export import save_reference_checkpoint
    from vtoonify_tpu_torch.models.lpips import load_lpips
    from vtoonify_tpu_torch.models.vtoonify import (
        CondDiscriminatorConfig,
        VToonifyConfig,
        init_cond_discriminator,
        init_vtoonify,
    )
    from vtoonify_tpu_torch.train import steps as S
    from vtoonify_tpu_torch.train import synth
    from vtoonify_tpu_torch.train.logging import SampleGridLogger
    from vtoonify_tpu_torch.utils import checkpoint as ckpt_util
    from vtoonify_tpu_torch.utils.blend import blend_generators

    cfg = VToonifyConfig(**(TL.TINY if args.tiny else {}), backbone="toonify")
    # blend recipes are written for 18 latents; smaller configs take the
    # entries that exist
    if len(args.weight) > cfg.n_latent:
        args.weight = args.weight[:cfg.n_latent]
    if len(args.weight) != cfg.n_latent:
        raise SystemExit(f"error: --weight needs {cfg.n_latent} entries for "
                         f"out_size {cfg.out_size}, got {len(args.weight)}")

    vt = init_vtoonify(cfg, torch.Generator().manual_seed(args.seed))
    base = ckpt_util.load_reference_stylegan(args.stylegan_path, cfg.generator)
    finetune = ckpt_util.load_reference_stylegan(args.finetunegan_path,
                                                 cfg.generator)
    # G1 = blend(finetune as low, base as high) (train_vtoonify_t.py:348-354)
    vt.generator = blend_generators(finetune, base, args.weight)
    del finetune
    base.to(device)
    parsing = ckpt_util.load_reference_faceparsing(args.faceparsing_path).to(device)
    directions = torch.from_numpy(
        ckpt_util.load_directions(args.direction_path)).float().to(device)

    gen = torch.Generator(device=device).manual_seed(args.seed)  # the draws
    prec = TL.precision(args)
    ckdir = f"checkpoint/{args.name}"

    if args.pretrain:
        state = S.init_pretrain_state(vt, args.lr, device=device)
        state_path = f"{ckdir}/pretrain_state.ckpt"
        if args.resume and os.path.exists(state_path):
            ckpt_util.load_train_state(state_path, state)
            args.start_iter = state.step
            print(f"resumed pretrain state at step {args.start_iter}")
        _, frozen = S.split_trainable(vt, pretrain=True)
        TL.shard(args, device, base, *frozen.values())  # the JAX trainer's tp trees

        def step(idx):
            return S.pretrain_t_step(state, frozen, base, parsing, cfg,
                                     directions, args.batch, generator=gen,
                                     **prec), {}

        def save(idx):
            name = TL.checkpoint_name(args, idx, "pretrain.ckpt",
                                      "pretrain-{:05d}.ckpt")
            if name is None:
                return
            enc = {"encoder": state.ema["encoder"]}
            ckpt_util.save_g_ema(f"{ckdir}/{name}", enc)
            ckpt_util.save_train_state(state_path, state)
            if args.export_pt:
                save_reference_checkpoint(
                    f"{ckdir}/{name.removesuffix('.ckpt')}.pt", enc, cfg)

        TL.train_loop(args, state, state_path, step, save)
        return

    # ---- full training ------------------------------------------------------
    vt.encoder.load_state_dict(ckpt_util.load_g_ema(args.encoder_path)["encoder"])
    S.fusion_identity_init(vt)  # T's plain-conv fusion (train_vtoonify_t.py:362-368)
    psp, latent_avg, psp_cfg = ckpt_util.load_reference_psp(args.style_encoder_path)
    psp.to(device)
    lpips, lpips_desc = load_lpips(args.vgg_path, args.lpips_lin_path,
                                   allow_random=args.allow_random_lpips)
    print(f"LPIPS weights: {lpips_desc}")
    dcfg = CondDiscriminatorConfig(size=64 if args.tiny else 256,
                                   channel_multiplier=1 if args.tiny else 2,
                                   use_condition=False)
    d = init_cond_discriminator(dcfg, torch.Generator().manual_seed(args.seed + 1))
    tcfg = S.TrainDConfig(adv_loss=args.adv_loss, grec_loss=args.grec_loss,
                          perc_loss=args.perc_loss, tmp_loss=args.tmp_loss,
                          lr=args.lr, **prec, **(TL.TINY_TCFG if args.tiny else {}))

    TL.shard(args, device, vt, d, base)  # the JAX trainer's tp trees
    _, frozen = S.split_trainable(vt)
    state = S.init_train_t_state(vt, d, tcfg, device=device)
    state_path = f"{ckdir}/train_state.ckpt"
    if args.resume and os.path.exists(state_path):
        ckpt_util.load_train_state(state_path, state)
        args.start_iter = state.step
        print(f"resumed full train state at step {args.start_iter}")
    latent_avg = latent_avg.to(device)
    glog = (SampleGridLogger(f"log/{args.name}", cfg, fix_degree=True,
                             use_degree=False) if TL.is_main() else None)

    def step(idx):
        draws = S.sample_train_t_draws(gen, args.batch, cfg, tcfg,
                                       directions.shape[0], device=device)
        if glog is not None and idx == args.start_iter:  # the fixed sample: this step's data
            with torch.no_grad():
                glog.seed(synth.synth_train_t_batch(
                    draws, base, cfg.generator, vt, cfg, parsing, psp, psp_cfg,
                    latent_avg, directions, aug_p=tcfg.aug_p,
                    aug_max_pad=tcfg.aug_max_pad), 0.0)
        return S.train_t_step(
            state, frozen, base, parsing, psp, psp_cfg, latent_avg, lpips, cfg,
            dcfg, tcfg, directions, args.batch,
            max(idx / (args.iter / 2.0) - 1, 0), draws=draws), {}

    def log_grid(idx):
        if idx % args.log_every == 0 or (idx + 1) == args.iter:
            glog.log(idx, {**frozen, **state.ema}, 0.0)

    def save(idx):
        name = TL.checkpoint_name(args, idx, "vtoonify.ckpt", "vtoonify_{:05d}.ckpt")
        if name is None:
            return
        ckpt_util.save_g_ema(f"{ckdir}/{name}", dict(state.ema.items()))
        ckpt_util.save_train_state(state_path, state)
        if args.export_pt:
            save_reference_checkpoint(f"{ckdir}/{name.removesuffix('.ckpt')}.pt",
                                      {**frozen, **state.ema}, cfg)

    TL.train_loop(args, state, state_path, step, save, log_grid)


if __name__ == "__main__":
    main()
