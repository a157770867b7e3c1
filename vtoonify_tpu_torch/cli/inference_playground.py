"""Inference playground over the port's Model (port of
examples/inference_playground.py, the script equivalent of the reference's
notebooks/inference_playground.ipynb): three parts, a one-call demo, the
VToonify-D walkthrough (a style-degree sweep) and style control (several
styles, then color transfer). Runs on the card unless --cpu.

With reference checkpoints laid out as in checkpoint/README.md:

    python -m vtoonify_tpu_torch.cli.inference_playground \
        --checkpoint_root ./checkpoint --content data/077436.jpg
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_root", default="./checkpoint")
    ap.add_argument("--content", default="./data/077436.jpg")
    ap.add_argument("--out", default="./output/playground")
    ap.add_argument("--landmarks", default=None,
                    help="precomputed 68-pt landmarks .npy (dlib-free)")
    ap.add_argument("--style_type", default="cartoon1",
                    help="part-1 demo style (registry name)")
    ap.add_argument("--model", default="cartoon1-d",
                    help="part-2 walkthrough model (registry name)")
    ap.add_argument("--styles", default="cartoon1-d,cartoon2-d,cartoon3-d",
                    help="part-3 style-control sweep (comma-separated)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import cv2

    from vtoonify_tpu_torch.pipeline.model_api import Model

    styles = [s.strip() for s in args.styles.split(",") if s.strip()]
    if not styles:
        ap.error("--styles must name at least one registry style")

    # ---- Part 1: one-call demo ---------------------------------------------
    # Model/StaticLandmarker accept an .npy path directly
    m = Model(checkpoint_root=args.checkpoint_root, landmarks=args.landmarks,
              device="cpu" if args.cpu else None)
    frame, aligned, msg = m.detect_and_align_image(args.content)
    print("align:", msg)
    out = m.image_toonify(frame, aligned, style_degree=0.5,
                          style_type=args.style_type)
    cv2.imwrite(os.path.join(args.out, f"demo_{args.style_type}.jpg"),
                cv2.cvtColor(out, cv2.COLOR_RGB2BGR))

    # ---- Part 2: VToonify-D walkthrough ------------------------------------
    # The pipeline pieces, spelled out (what Model does internally):
    pipe = m.load_model(args.model)
    s_w = pipe.compute_style(aligned, color_transfer=False)
    for d_s in (0.0, 0.5, 1.0):
        img = pipe.process_image(frame, s_w, d_s)
        cv2.imwrite(os.path.join(args.out, f"walkthrough_ds{d_s:.1f}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    print("style-degree sweep written")

    # ---- Part 3: style control ---------------------------------------------
    # Different exemplars/models + color transfer on/off.
    for style_type in styles:
        img = m.image_toonify(frame, aligned, style_degree=0.6,
                              style_type=style_type)
        cv2.imwrite(os.path.join(args.out, f"style_{style_type}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    img = m.image_toonify(frame, aligned, style_degree=0.6,
                          style_type=styles[0], color_transfer=True)
    cv2.imwrite(os.path.join(args.out, "style_color_transfer.jpg"),
                cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    print("done ->", args.out)


if __name__ == "__main__":
    main()
