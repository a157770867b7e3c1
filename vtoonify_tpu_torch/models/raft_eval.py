"""RAFT evaluation: end-point error and the `vtoonify-raft-eval` command
(port of vtoonify_tpu/models/raft_eval.py).

    python -m vtoonify_tpu_torch.models.raft_eval --model raft-things.pth \\
        --dataset sintel --data_root datasets [--submission DIR --warm_start]

Runs on the card unless --cpu (raises without one); there the convolutions
and matmuls run in TF32 (with TF32 off cuDNN picks FFT algorithms for RAFT's
3x3 convs, 10-20x slower), and --mixed_precision runs the model under
bfloat16 autocast.
"""

from __future__ import annotations

import numpy as np
import torch

from vtoonify_tpu_torch.models.raft import RAFTConfig, raft_apply


def end_point_error(flow_pred, flow_gt, valid=None):
    """Mean EPE and the 1/3/5 px accuracies (reference raft/evaluate.py):
    flows (..., 2, H, W), valid (..., H, W). With a mask the EPE averages
    over valid pixels, the accuracies over all pixels (an invalid pixel
    counts as within 1 px), as the JAX package defines them."""
    epe = torch.sqrt(torch.sum(torch.square(flow_pred - flow_gt), dim=-3))
    if valid is not None:
        epe = torch.where(valid.bool(), epe, torch.zeros((), dtype=epe.dtype,
                                                        device=epe.device))
        mean = torch.sum(epe) / torch.clamp(torch.sum(valid.float()), min=1)
    else:
        mean = torch.mean(epe)
    return {"epe": float(mean),
            "1px": float(torch.mean((epe < 1).float())),
            "3px": float(torch.mean((epe < 3).float())),
            "5px": float(torch.mean((epe < 5).float()))}


def evaluate_pairs(model, pairs, iters: int = 24, cfg: RAFTConfig = RAFTConfig()):
    """pairs: iterable of (im1, im2, flow_gt) numpy arrays, images
    (B, H, W, 3) in [0, 255] and flows (B, H, W, 2), H and W multiples of 8.
    Runs on the device of `model`; returns the mean metrics."""
    dev = next(model.parameters()).device

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).permute(0, 3, 1, 2)

    results = []
    with torch.inference_mode():
        for im1, im2, gt in pairs:
            _, flow = raft_apply(model, nchw(im1), nchw(im2), cfg, iters=iters)
            results.append(end_point_error(flow.float(), nchw(gt)))
    return ({k: float(np.mean([r[k] for r in results])) for k in results[0]}
            if results else {})


def main(argv=None):
    """`vtoonify-raft-eval`, the reference's evaluate.py __main__
    (model/raft/evaluate.py:168-196): load a reference RAFT checkpoint, run
    the chairs / Sintel-train / KITTI-train validation or write a
    leaderboard submission, print the result as JSON."""
    import argparse
    import json
    import os

    p = argparse.ArgumentParser(
        description="Evaluate a RAFT checkpoint (Sintel/KITTI EPE), PyTorch + CUDA")
    p.add_argument("--model", required=True,
                   help="reference RAFT checkpoint (e.g. raft-things.pth)")
    p.add_argument("--dataset", required=True, choices=["chairs", "sintel", "kitti"])
    p.add_argument("--data_root", default="datasets",
                   help="directory holding FlyingChairs_release/, Sintel/ or KITTI/")
    p.add_argument("--dstype", default="clean", choices=["clean", "final"],
                   help="Sintel rendering pass")
    p.add_argument("--iters", type=int, default=None,
                   help="refinement iterations (default: the reference's "
                        "32 for sintel, 24 for kitti and chairs)")
    p.add_argument("--submission", type=str, default=None, metavar="DIR",
                   help="write a leaderboard submission for --dataset into "
                        "DIR instead of validating (reference evaluate.py "
                        "create_{sintel,kitti}_submission)")
    p.add_argument("--warm_start", action="store_true",
                   help="Sintel submission: forward-interpolate each "
                        "sequence's low-res flow into the next frame's init")
    p.add_argument("--small", action="store_true",
                   help="(reference flag) small architecture — unsupported")
    p.add_argument("--mixed_precision", action="store_true",
                   help="run the model under bfloat16 autocast")
    p.add_argument("--alternate_corr", action="store_true",
                   help="memory-efficient on-the-fly correlation "
                        "(alt_cuda_corr equivalent; exact)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    if args.small:
        raise SystemExit("--small: the small RAFT architecture is not supported; "
                         "VToonify uses the full model (raft-things.pth)")
    if args.submission is not None and args.dataset == "chairs":
        raise SystemExit("--submission: chairs has no leaderboard test split")

    from vtoonify_tpu_torch import resolve_device
    from vtoonify_tpu_torch.models import raft_data as RD
    from vtoonify_tpu_torch.pipeline.smooth_parsing import float32_precision
    from vtoonify_tpu_torch.utils.checkpoint import load_reference_raft

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = RAFTConfig(corr_impl="alt" if args.alternate_corr else "allpairs")
    model = load_reference_raft(args.model, cfg).to(dev)

    with float32_precision(True), torch.autocast(dev.type, torch.bfloat16,
                                                 enabled=args.mixed_precision):
        if args.submission is not None:
            if args.dataset == "sintel":
                written = RD.create_sintel_submission(
                    model, os.path.join(args.data_root, "Sintel"), args.submission,
                    iters=args.iters or 32, warm_start=args.warm_start, cfg=cfg)
            else:
                written = RD.create_kitti_submission(
                    model, os.path.join(args.data_root, "KITTI"), args.submission,
                    iters=args.iters or 24, cfg=cfg)
            print(json.dumps({"dataset": args.dataset, "submission": args.submission,
                              "files": len(written)}))
            return {"files": len(written)}
        if args.dataset == "chairs":
            split = os.path.join(args.data_root, "chairs_split.txt")
            metrics = RD.validate_chairs(
                model, os.path.join(args.data_root, "FlyingChairs_release/data"),
                split_file=split if os.path.exists(split) else None,
                iters=args.iters or 24, cfg=cfg)
        elif args.dataset == "sintel":
            metrics = RD.validate_sintel(
                model, os.path.join(args.data_root, "Sintel"), dstype=args.dstype,
                iters=args.iters or 32, cfg=cfg)
        else:
            metrics = RD.validate_kitti(
                model, os.path.join(args.data_root, "KITTI"),
                iters=args.iters or 24, cfg=cfg)
    print(json.dumps({"dataset": args.dataset, **metrics}))
    return metrics


if __name__ == "__main__":
    main()
