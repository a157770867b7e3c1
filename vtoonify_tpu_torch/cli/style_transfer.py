"""Style-transfer CLI — option-parity with reference style_transfer.py:17-46
(port of vtoonify_tpu/cli/style_transfer.py).

Usage:
  python -m vtoonify_tpu_torch.cli.style_transfer --content data/077436.jpg \
      --ckpt checkpoint/vtoonify_d_cartoon/vtoonify_s_d.pt --scale_image

Reads the reference's PyTorch checkpoints (mapped on load) and runs on the
card unless --cpu. Decoding and encoding images and videos needs cv2. dlib
is optional: pass --landmarks <file.npy> with precomputed 68-point
landmarks when it is unavailable.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vtoonify_tpu_torch.pipeline import crop as crop_mod
from vtoonify_tpu_torch.pipeline.landmarks import make_landmarker
from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
from vtoonify_tpu_torch.pipeline.video import toonify_video
from vtoonify_tpu_torch.utils import checkpoint as ckpt_util
from vtoonify_tpu_torch.utils.profiling import StageTimer


def build_parser():
    p = argparse.ArgumentParser(description="Style Transfer (PyTorch + CUDA)")
    p.add_argument("--content", type=str, default="./data/077436.jpg",
                   help="path of the content image/video")
    p.add_argument("--style_id", type=int, default=26,
                   help="the id of the style image")
    p.add_argument("--style_degree", type=float, default=0.5,
                   help="style degree for VToonify-D")
    p.add_argument("--color_transfer", action="store_true",
                   help="transfer the color of the style")
    p.add_argument("--ckpt", type=str,
                   default="./checkpoint/vtoonify_d_cartoon/vtoonify_s_d.pt",
                   help="path of the saved model")
    p.add_argument("--output_path", type=str, default="./output/")
    p.add_argument("--scale_image", action="store_true",
                   help="resize and crop the image to best fit the model")
    p.add_argument("--style_encoder_path", type=str,
                   default="./checkpoint/encoder.pt")
    p.add_argument("--exstyle_path", type=str, default=None)
    p.add_argument("--faceparsing_path", type=str,
                   default="./checkpoint/faceparsing.pth")
    p.add_argument("--video", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--backbone", type=str, default=None,
                   choices=["dualstylegan", "toonify"],
                   help="inferred from the checkpoint when omitted; an "
                        "explicit value is validated against it")
    p.add_argument("--padding", type=int, nargs=4,
                   default=[200, 200, 200, 200],
                   help="left, right, top, bottom paddings to the face center")
    p.add_argument("--batch_size", type=int, default=None,
                   help="video frames per device dispatch; default picks a "
                        "resolution-aware batch (16 at the standard 256px "
                        "crop on the card; the reference's fixed default is 4)")
    p.add_argument("--parsing_map_path", type=str, default=None)
    p.add_argument("--landmark_model", type=str,
                   default="./checkpoint/shape_predictor_68_face_landmarks.dat")
    p.add_argument("--landmarks", type=str, default=None,
                   help="precomputed 68-point landmarks .npy (dlib-free path)")
    p.add_argument("--fp32", action="store_true",
                   help="run in float32 instead of bfloat16, with TF32 off "
                        "for cuDNN convs and matmuls unless "
                        "--matmul_precision overrides")
    p.add_argument("--matmul_precision", type=str, default=None,
                   choices=["default", "high", "highest"],
                   help="float32 conv/matmul precision: 'highest' no TF32, "
                        "'high' TF32 for convs and matmuls, 'default' "
                        "torch's own (TF32 for cuDNN convs only)")
    p.add_argument("--sp", type=int, default=None,
                   help="spatial partitioning: split each frame's rows over "
                        "the first N cards (batch-1 latency scale-out; halo "
                        "rows and global means exchanged between them)")
    p.add_argument("--dp", type=int, default=None,
                   help="frame parallelism: a replica of the model on each "
                        "of the first N cards, the frames of a batch split "
                        "over them")
    p.add_argument("--profile", action="store_true",
                   help="print the video engine's stage breakdown after "
                        "video processing: decode, preprocess, dispatch, "
                        "copy_enqueue (on a card), fetch (fetch_wait + "
                        "fetch_copy), write, encode")
    p.add_argument("--frame_limit", type=int, default=None,
                   help="process at most N video frames")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.exstyle_path is None:
        args.exstyle_path = os.path.join(os.path.dirname(args.ckpt),
                                         "exstyle_code.npy")
    print("Load options")
    for name, value in sorted(vars(args).items()):
        print(f"{name}: {value}")
    return args


def set_float32_precision(prec):
    """'highest': no TF32; 'high': TF32 for cuDNN convs and matmuls;
    'default': torch's defaults (TF32 for cuDNN convs, not for matmuls)."""
    torch.backends.cudnn.allow_tf32 = prec != "highest"
    torch.set_float32_matmul_precision("high" if prec == "high" else "highest")


def main(argv=None):
    args = parse_args(argv)
    if args.sp and args.dp:
        raise SystemExit("error: --sp and --dp are mutually exclusive")
    mesh = None
    if args.sp or args.dp:
        from vtoonify_tpu_torch.parallel.mesh import make_mesh, make_spatial_mesh

        flag, n = ("--sp", args.sp) if args.sp else ("--dp", args.dp)
        visible = 0 if args.cpu else torch.cuda.device_count()
        if visible < n:
            raise SystemExit(f"error: {flag} {n} but only {visible} "
                             "devices are visible")
        mesh = make_spatial_mesh(n) if args.sp else make_mesh(n)

    prec = args.matmul_precision or ("highest" if args.fp32 else None)
    if prec is not None:
        set_float32_precision(prec)

    if not os.path.exists(args.content):
        raise SystemExit(f"error: content file not found: {args.content}")

    # model config (sizes, multiplier, backbone) is inferred from the
    # checkpoint — the reference hardcodes 256→1024
    vt, cfg = ckpt_util.load_reference_vtoonify(args.ckpt)
    if args.backbone is not None and cfg.backbone != args.backbone:
        raise SystemExit(f"error: --backbone {args.backbone} but {args.ckpt} "
                         f"is a {cfg.backbone} model")
    args.backbone = cfg.backbone
    parsing = ckpt_util.load_reference_faceparsing(args.faceparsing_path)
    psp, latent_avg, psp_cfg = ckpt_util.load_reference_psp(args.style_encoder_path)

    exstyle = None
    if args.backbone == "dualstylegan":
        bank, names = ckpt_util.load_exstyle_bank(args.exstyle_path)
        if not 0 <= args.style_id < len(names):
            raise SystemExit(f"error: --style_id {args.style_id} out of range; "
                             f"{args.exstyle_path} has styles 0..{len(names) - 1}")
        exstyle = bank[names[args.style_id]]

    pipe = ToonifyPipeline(
        vt, cfg, parsing, psp_params=psp, psp_cfg=psp_cfg, latent_avg=latent_avg,
        exstyle=exstyle, dtype=torch.float32 if args.fp32 else torch.bfloat16,
        mesh=mesh, device="cpu" if args.cpu else None)

    # like the reference (style_transfer.py:70-77), a missing dlib model is
    # fetched on first use (pipeline/landmarks.py::ensure_predictor); with
    # --landmarks the dlib path is bypassed entirely
    landmarker = make_landmarker(
        predictor_path=args.landmark_model if args.landmarks is None else None,
        landmarks=args.landmarks)

    basename = os.path.basename(args.content).split(".")[0]
    suffix = "_vtoonify_" + args.backbone[0]
    os.makedirs(args.output_path, exist_ok=True)
    print(f"Processing {os.path.basename(args.content)} with vtoonify_"
          f"{args.backbone[0]}")

    if args.video:
        parsing_maps = None
        if args.parsing_map_path is not None:
            parsing_maps = np.load(args.parsing_map_path)
            if parsing_maps.ndim == 4 and parsing_maps.shape[1] == 19:
                parsing_maps = np.transpose(parsing_maps, (0, 2, 3, 1))
        result = toonify_video(
            pipe, args.content,
            os.path.join(args.output_path, basename + suffix + ".mp4"),
            style_degree=args.style_degree, color_transfer=args.color_transfer,
            landmarker=landmarker, scale_image=args.scale_image,
            padding=tuple(args.padding), batch_size=args.batch_size,
            crop_out_path=os.path.join(args.output_path, basename + "_input.mp4"),
            parsing_maps=parsing_maps, timer=StageTimer() if args.profile else None,
            frame_limit=args.frame_limit)
        print(f"{result.frames_written} frames written")
        if result.stages:
            print("stage breakdown (wall-clock, overlapped; fetch = fetch_wait + fetch_copy):")
            width = max(map(len, result.stages))
            for name, s in sorted(result.stages.items()):
                print(f"  {name:<{width}s} total {s['total_s']:.2f}s over "
                      f"{s['count']} calls (mean {s['mean_ms']:.1f} ms)")
    else:
        import cv2

        frame = cv2.cvtColor(cv2.imread(args.content), cv2.COLOR_BGR2RGB)
        crop_params = None
        if args.scale_image:
            crop_params = crop_mod.get_video_crop_parameter(
                frame, landmarker, tuple(args.padding))
        frame = crop_mod.preprocess_frame(frame, crop_params, args.scale_image)
        aligned = crop_mod.align_face(frame, landmarker)
        s_w = pipe.compute_style(aligned, args.color_transfer)
        out = pipe.process_image(frame, s_w, args.style_degree)
        cv2.imwrite(os.path.join(args.output_path, basename + "_input.jpg"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(args.output_path, basename + suffix + ".jpg"),
                    cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
    print("Transfer style successfully!")


if __name__ == "__main__":
    main()
