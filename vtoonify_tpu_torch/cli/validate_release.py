"""Release-validation gate over the port (port of
vtoonify_tpu/cli/validate_release.py): replay the reference's golden-output
repro commands through the port's style-transfer CLI and report PSNR
against its committed golden images.

The reference's regression fixtures are the images in `output/` plus the
exact CLIs that reproduce them (reference output/readme.md:1-65). This tool
drives every one of those commands through
`vtoonify_tpu_torch.cli.style_transfer.main`, in process, and prints a
per-case PSNR table with a pass/fail gate (PSNR >= 35 dB against the
reference's outputs). With the released checkpoints present, parity is one
command:

    python -m vtoonify_tpu_torch.cli.validate_release \
        --checkpoint_root ./checkpoint --data_root ./data --golden_root ./output

Runs on the card unless --cpu. Notes:
  * 529_vtoonify_d.mp4 is only linked (not committed) in the reference, so
    the video case validates the cropped *input* video (529_input.mp4 is
    committed), the full preprocessing chain, and renders the stylized
    video without a PSNR gate.
  * `--cases` selects a subset; `--landmarks_root` supplies precomputed
    68-point landmark .npy files (named <basename>.npy) for dlib-free runs.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from vtoonify_tpu_torch import resolve_device

MIN_PSNR_DB = 35.0  # the parity gate against the reference's outputs


@dataclass(frozen=True)
class Case:
    """One golden-output repro command (reference output/readme.md)."""

    name: str                  # golden image stem, e.g. 077436_vtoonify_d
    content: str               # data-root-relative input
    ckpt: str                  # checkpoint-root-relative model path
    style_id: Optional[int] = None
    padding: Tuple[int, int, int, int] = (200, 200, 200, 200)
    backbone: str = "dualstylegan"
    video: bool = False
    extra: Tuple[str, ...] = ()


CASES: List[Case] = [
    # python style_transfer.py --scale_image          (output/readme.md:14-16)
    Case("077436_vtoonify_d", "077436.jpg",
         "vtoonify_d_cartoon/vtoonify_s_d.pt", style_id=26),
    # --content 081680.jpg --ckpt …s026_d0.5.pt       (output/readme.md:22-26)
    Case("081680_vtoonify_d", "081680.jpg",
         "vtoonify_d_cartoon/vtoonify_s026_d0.5.pt", style_id=26),
    # --padding 600⁴ --style_id 77 arcane             (output/readme.md:31-36)
    Case("038648_vtoonify_d", "038648.jpg",
         "vtoonify_d_arcane/vtoonify_s_d.pt", style_id=77,
         padding=(600, 600, 600, 600)),
    # --backbone toonify arcane                       (output/readme.md:41-46)
    Case("038648_vtoonify_t", "038648.jpg",
         "vtoonify_t_arcane/vtoonify.pt", backbone="toonify",
         padding=(600, 600, 600, 600)),
    Case("077559_vtoonify_d", "077559.jpg",
         "vtoonify_d_arcane/vtoonify_s_d.pt", style_id=77,
         padding=(600, 600, 600, 600)),
    Case("077559_vtoonify_t", "077559.jpg",
         "vtoonify_t_arcane/vtoonify.pt", backbone="toonify",
         padding=(600, 600, 600, 600)),
    # video: golden = committed cropped-input 529_input.mp4 (readme.md:5-8)
    Case("529_input", "529.mp4",
         "vtoonify_d_cartoon/vtoonify_s_d.pt", style_id=26, video=True),
]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean(np.square(a - b))
    if mse == 0:
        return float("inf")
    # a Python float: the --json_out report and the pass flags stay JSON
    return float(10.0 * np.log10(255.0 * 255.0 / mse))


def _video_psnr(path_a: str, path_b: str, max_frames: int = 64):
    """Mean per-frame PSNR between two videos (frame-count must match on the
    compared prefix)."""
    import cv2

    ca, cb = cv2.VideoCapture(path_a), cv2.VideoCapture(path_b)
    vals = []
    while len(vals) < max_frames:
        oka, fa = ca.read()
        okb, fb = cb.read()
        if not (oka and okb):
            break
        if fa.shape != fb.shape:
            ca.release()
            cb.release()
            return None, f"frame shape {fa.shape} != golden {fb.shape}"
        vals.append(psnr(fa, fb))
    ca.release()
    cb.release()
    if not vals:
        return None, "no comparable frames"
    return float(np.mean(vals)), f"{len(vals)} frames"


def build_parser():
    p = argparse.ArgumentParser(
        description="Replay the reference golden-output commands through "
                    "the PyTorch port and gate on PSNR vs the golden images")
    p.add_argument("--checkpoint_root", type=str, default="./checkpoint")
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--golden_root", type=str, default="./output",
                   help="directory holding the reference golden outputs")
    p.add_argument("--output_path", type=str, default=None,
                   help="where to write the port's outputs "
                        "(default: a temp dir)")
    p.add_argument("--min_psnr", type=float, default=MIN_PSNR_DB)
    p.add_argument("--cases", type=str, nargs="*", default=None,
                   help="subset of case names to run")
    p.add_argument("--skip_video", action="store_true")
    p.add_argument("--landmarks_root", type=str, default=None,
                   help="directory of precomputed <basename>.npy 68-point "
                        "landmarks (dlib-free validation)")
    p.add_argument("--frame_limit", type=int, default=None,
                   help="cap video frames (smoke runs)")
    p.add_argument("--json_out", type=str, default=None,
                   help="also write the per-case results as JSON")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def run_case(case: Case, args, out_dir: str):
    """Drive the port's cli.style_transfer for one case; returns
    (psnr | None, detail)."""
    import cv2

    from vtoonify_tpu_torch.cli import style_transfer

    content = os.path.join(args.data_root, case.content)
    ckpt = os.path.join(args.checkpoint_root, case.ckpt)
    for path, what in ((content, "content"), (ckpt, "checkpoint")):
        if not os.path.exists(path):
            return None, f"missing {what}: {path}"

    argv = [
        "--content", content, "--ckpt", ckpt, "--scale_image",
        "--output_path", out_dir,
        "--faceparsing_path",
        os.path.join(args.checkpoint_root, "faceparsing.pth"),
        "--style_encoder_path",
        os.path.join(args.checkpoint_root, "encoder.pt"),
        "--padding", *[str(v) for v in case.padding],
        "--backbone", case.backbone,
    ]
    if case.style_id is not None:
        argv += ["--style_id", str(case.style_id)]
    if case.video:
        argv += ["--video"]
    if args.frame_limit is not None:
        argv += ["--frame_limit", str(args.frame_limit)]
    if args.cpu:
        argv += ["--cpu"]
    if args.landmarks_root is not None:
        lm = os.path.join(args.landmarks_root,
                          case.content.split(".")[0] + ".npy")
        if not os.path.exists(lm):
            return None, f"missing landmarks: {lm}"
        argv += ["--landmarks", lm]
    argv += list(case.extra)

    style_transfer.main(argv)

    base = os.path.basename(case.content).split(".")[0]
    if case.video:
        # golden = the committed cropped-input video; ours is crop_out_path
        ours = os.path.join(out_dir, base + "_input.mp4")
        golden = os.path.join(args.golden_root, case.name + ".mp4")
        if not os.path.exists(golden):
            return None, f"missing golden: {golden}"
        return _video_psnr(ours, golden)

    suffix = "_vtoonify_" + case.backbone[0]
    ours_path = os.path.join(out_dir, base + suffix + ".jpg")
    golden_path = os.path.join(args.golden_root, case.name + ".jpg")
    if not os.path.exists(golden_path):
        return None, f"missing golden: {golden_path}"
    ours = cv2.imread(ours_path)
    golden = cv2.imread(golden_path)
    if ours is None:
        return None, f"no output produced at {ours_path}"
    if golden is None:
        return None, f"unreadable golden image: {golden_path}"
    if ours.shape != golden.shape:
        return None, f"shape {ours.shape} != golden {golden.shape}"
    return psnr(ours, golden), f"{ours.shape[1]}x{ours.shape[0]}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device("cpu" if args.cpu else None)  # no card: raise before any case
    out_dir = args.output_path or tempfile.mkdtemp(prefix="vtoonify_validate_")
    os.makedirs(out_dir, exist_ok=True)

    selected = [
        c for c in CASES
        if (args.cases is None or c.name in args.cases)
        and not (args.skip_video and c.video)
    ]
    if args.cases:
        known = {c.name for c in CASES}
        for name in args.cases:
            if name not in known:
                raise SystemExit(f"error: unknown case {name!r}; "
                                 f"known: {sorted(known)}")

    results = []
    for case in selected:
        try:
            value, detail = run_case(case, args, out_dir)
        except SystemExit as e:  # CLI-level failure (bad ckpt etc.)
            value, detail = None, f"command failed: {e}"
        ok = value is not None and value >= args.min_psnr
        results.append({"case": case.name, "psnr_db": value,
                        "detail": detail, "pass": ok})
        shown = "inf" if value == float("inf") else (
            f"{value:.2f}" if value is not None else "—")
        print(f"[{'PASS' if ok else 'FAIL'}] {case.name:<22s} "
              f"PSNR {shown:>7s} dB  ({detail})", flush=True)

    n_pass = sum(r["pass"] for r in results)
    print(f"\n{n_pass}/{len(results)} cases >= {args.min_psnr} dB "
          f"(outputs in {out_dir})")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"min_psnr": args.min_psnr, "results": results}, f,
                      indent=2)
    return 0 if n_pass == len(results) and results else 1


if __name__ == "__main__":
    raise SystemExit(main())
