"""VToonify-D trainer CLI — option parity with reference
train_vtoonify_d.py:31-75 (port of vtoonify_tpu/cli/train_d.py): two
stages, --pretrain (encoder distillation) then full training.

Usage (the card; add --cpu for the CPU):
  python -m vtoonify_tpu_torch.cli.train_d --pretrain --name vtoonify_d_cartoon
  python -m vtoonify_tpu_torch.cli.train_d --name vtoonify_d_cartoon \
      --export_pt

Reads the reference's checkpoints (DualStyleGAN generator.pt, BiSeNet
faceparsing.pth, pSp encoder.pt, exstyle_code.npy, directions.npy) and
writes checkpoint/NAME/{pretrain.ckpt, pretrain_state.ckpt,
vtoonify_s*_d*.ckpt, train_state.ckpt} (torch.save files; `--resume`
reads the *_state.ckpt) and, with --export_pt, reference-format .pt files;
logs go to log/NAME/. Several cards: one process each, under `torchrun
--nproc_per_node=N -m vtoonify_tpu_torch.cli.train_d ...` or with
--multihost --coordinator HOST:PORT --num_processes N --process_id R;
--batch is the global batch and rank 0 alone writes. --tp k splits the
wide weights of the frozen backbone (both stages) and of the student and the
discriminator (stage 2) over k cards a rank (cuda:LOCAL_RANK * k onward;
with --cpu the CPU k times), as the JAX trainer splits them over 'tp'.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vtoonify_tpu_torch.cli import _train_loop as TL
from vtoonify_tpu_torch.parallel.mesh import shard_process_local_batch


def build_parser():
    p = argparse.ArgumentParser(description="Train VToonify-D (PyTorch + CUDA)")
    TL.add_common_args(p, "train_vtoonify_d.py:38")
    p.add_argument("--msk_loss", type=float, default=0.0005)
    p.add_argument("--fix_degree", action="store_true")
    p.add_argument("--fix_style", action="store_true")
    p.add_argument("--fix_color", action="store_true")
    p.add_argument("--exstyle_path", type=str,
                   default="./checkpoint/cartoon/refined_exstyle_code.npy")
    p.add_argument("--style_id", type=int, default=26)
    p.add_argument("--style_degree", type=float, default=0.5)
    p.add_argument("--stylegan_path", type=str,
                   default="./checkpoint/cartoon/generator.pt")
    p.add_argument("--name", type=str, default="vtoonify_d_cartoon")
    return p


def capability_suffix(args) -> str:
    """reference train_vtoonify_d.py:193-200 / README.md:137-142."""
    s = "_s"
    if args.fix_style:
        s += "%03d" % args.style_id
    s += "_d"
    if args.fix_degree:
        s += "%1.1f" % args.style_degree
    if not args.fix_color:
        s += "_c"
    return s


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = TL.start(args)

    from vtoonify_tpu_torch.convert.torch_export import save_reference_checkpoint
    from vtoonify_tpu_torch.models.lpips import load_lpips
    from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig
    from vtoonify_tpu_torch.models.vtoonify import (
        CondDiscriminatorConfig,
        VToonifyConfig,
        init_cond_discriminator,
        init_vtoonify,
        zplus2wplus,
    )
    from vtoonify_tpu_torch.train import steps as S
    from vtoonify_tpu_torch.train import synth
    from vtoonify_tpu_torch.train.logging import SampleGridLogger
    from vtoonify_tpu_torch.utils import checkpoint as ckpt_util

    cfg = VToonifyConfig(**(TL.TINY if args.tiny else {}), backbone="dualstylegan")
    # frozen backbone from the DualStyleGAN checkpoint; the encoder's
    # dilated ModRes copies start from its ModRes weights
    # (train_vtoonify_d.py:419-424)
    vt = init_vtoonify(cfg, torch.Generator().manual_seed(args.seed))
    vt.generator = ckpt_util.load_reference_dualstylegan(args.stylegan_path,
                                                         cfg.dualstylegan)
    for j in range(7):
        vt.res[j].load_state_dict(vt.generator.res[j].state_dict())
    parsing = ckpt_util.load_reference_faceparsing(args.faceparsing_path).to(device)
    directions = torch.from_numpy(
        ckpt_util.load_directions(args.direction_path)).float().to(device)
    bank, names = ckpt_util.load_exstyle_bank(args.exstyle_path)
    with torch.no_grad():
        styles = torch.cat([zplus2wplus(vt, cfg, torch.from_numpy(bank[n]).float())
                            for n in names]).to(device)

    rng = np.random.RandomState(args.seed)
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
        TL.shard(args, device, *frozen.values())  # the JAX trainer's tp trees

        def step(idx):
            # d_s schedule (train_vtoonify_d.py:108-112)
            if args.fix_degree:
                d_s = args.style_degree
            else:
                d_s = 0.0 if idx <= args.iter / 4.0 else float(rng.rand())
            if args.fix_style:
                sel = np.full((args.batch,), args.style_id)
            else:
                sel = rng.randint(0, styles.shape[0], (args.batch,))
            sel = shard_process_local_batch(sel)  # this rank's rows
            metrics = S.pretrain_step(state, frozen, parsing, cfg, directions,
                                      styles[torch.from_numpy(sel).to(device)],
                                      d_s, generator=gen, **prec)
            return metrics, {"d_s": float(d_s)}

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
    S.fusion_identity_init(vt)  # train_vtoonify_d.py:433-438
    psp, latent_avg, psp_cfg = ckpt_util.load_reference_psp(
        args.style_encoder_path, PSPEncoderConfig(n_styles=cfg.n_latent))
    psp.to(device)
    lpips, lpips_desc = load_lpips(args.vgg_path, args.lpips_lin_path,
                                   allow_random=args.allow_random_lpips)
    print(f"LPIPS weights: {lpips_desc}")
    dcfg = CondDiscriminatorConfig(
        size=64 if args.tiny else 256,
        channel_multiplier=1 if args.tiny else 2,
        use_condition=True, style_num=styles.shape[0])
    d = init_cond_discriminator(dcfg, torch.Generator().manual_seed(args.seed + 1))
    tcfg = S.TrainDConfig(
        adv_loss=args.adv_loss, grec_loss=args.grec_loss,
        perc_loss=args.perc_loss, tmp_loss=args.tmp_loss,
        msk_loss=args.msk_loss, lr=args.lr, **prec,
        **(TL.TINY_TCFG if args.tiny else {}))

    TL.shard(args, device, vt, d)  # the JAX trainer's tp trees
    _, frozen = S.split_trainable(vt)
    state = S.init_train_d_state(vt, d, TL.local_batch(args), cfg, tcfg,
                                 device=device)
    state_path = f"{ckdir}/train_state.ckpt"
    if args.resume and os.path.exists(state_path):
        ckpt_util.load_train_state(state_path, state)
        args.start_iter = state.step
        print(f"resumed full train state at step {args.start_iter}")
    latent_avg = latent_avg.to(device)
    glog = SampleGridLogger(f"log/{args.name}", cfg, args.fix_degree) if TL.is_main() else None
    suffix = capability_suffix(args)
    current = {}

    def step(idx):
        if args.fix_degree or idx == 0:
            d_s = args.style_degree
        else:
            d_s = rng.randint(0, 6) / 5.0
        weights = ([d_s] * 7 + ([0.0] if args.fix_color else [1.0])
                   * (cfg.n_latent - 7))
        if args.fix_style or idx == 0:
            sel = np.full((args.batch,), args.style_id)
        else:
            sel = rng.randint(0, styles.shape[0], (args.batch,))
        sel = torch.from_numpy(shard_process_local_batch(sel)).to(device)
        style = styles[sel]
        xl_override = style if (not args.fix_color and args.fix_style) else None
        use_jitter = (idx > 0 and idx >= args.iter / 2.0
                      and not args.fix_color and not args.fix_style)
        cft = idx / (args.iter / 2.0)
        draws = S.sample_train_d_draws(gen, args.batch, cfg, tcfg,
                                       directions.shape[0], device=device)
        if glog is not None and idx == args.start_iter:  # the fixed sample: this step's data
            with torch.no_grad():
                glog.seed(synth.synth_train_batch(
                    draws, vt, cfg, parsing, psp, psp_cfg, latent_avg,
                    directions, style, d_s, weights, state.wc_prev, cft,
                    use_jitter, xl_override=xl_override, aug_p=tcfg.aug_p,
                    aug_max_pad=tcfg.aug_max_pad), d_s)
        current["d_s"] = d_s
        metrics = S.train_d_step(
            state, frozen, parsing, psp, psp_cfg, latent_avg, lpips, cfg, dcfg,
            tcfg, directions, style, sel, d_s, weights,
            max(idx / (args.iter / 2.0) - 1, 0), cft, use_jitter,
            xl_override=xl_override, draws=draws)
        return metrics, {"d_s": float(d_s)}

    def log_grid(idx):
        if (idx == args.start_iter or (idx + 1) % args.log_every == 0
                or (idx + 1) == args.iter):
            glog.log(idx + 1, {**frozen, **state.ema}, current["d_s"])

    def save(idx):
        name = TL.checkpoint_name(args, idx, f"vtoonify{suffix}.ckpt",
                                  f"vtoonify{suffix}_{{:05d}}.ckpt")
        if name is None:
            return
        ckpt_util.save_g_ema(f"{ckdir}/{name}", dict(state.ema.items()))
        ckpt_util.save_train_state(state_path, state)
        if args.export_pt:  # the whole g_ema: frozen backbone + EMA trainables
            save_reference_checkpoint(f"{ckdir}/{name.removesuffix('.ckpt')}.pt",
                                      {**frozen, **state.ema}, cfg)

    TL.train_loop(args, state, state_path, step, save, log_grid)


if __name__ == "__main__":
    main()
