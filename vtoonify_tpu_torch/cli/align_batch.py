"""Batch FFHQ face alignment over a directory tree (port of
vtoonify_tpu/cli/align_batch.py).

    python -m vtoonify_tpu_torch.cli.align_batch --root_path faces \
        [--num_threads 4] [--landmarks lm.npy]

Parity with reference model/encoder/align_all_parallel.py:153-215: walks
--root_path, aligns every image with the FFHQ recipe, and writes 256px crops
to <root_path>_crops mirroring the tree (skipping non-image files and
existing outputs). A pool of spawned worker processes like the reference;
alignment is the port's host pipeline (pipeline/crop.py), so no device is
used. Exits 0 only if every pending image was aligned.

Landmarks come from dlib (--landmark_model) or, without dlib, from a
precomputed .npy file (--landmarks, reused for every image).
"""

from __future__ import annotations

import argparse
import math
import multiprocessing as mp
import os
import time

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

_worker_landmarker = None
_worker_args = None


def build_parser():
    p = argparse.ArgumentParser(
        description="Align all faces under a directory (FFHQ crop recipe)"
    )
    p.add_argument("--root_path", type=str, required=True)
    p.add_argument("--num_threads", type=int, default=1,
                   help="worker processes (reference option name kept)")
    p.add_argument("--landmark_model", type=str,
                   default="./checkpoint/shape_predictor_68_face_landmarks.dat")
    p.add_argument("--landmarks", type=str, default=None,
                   help="precomputed (68,2) landmarks .npy — hermetic "
                        "alternative to dlib")
    p.add_argument("--output_size", type=int, default=256)
    return p


def list_pending(root_path: str):
    """(src, dst) pairs mirroring the reference's walk/skip rules."""
    out_root = root_path.rstrip("/") + "_crops"
    pairs = []
    for root, _, files in os.walk(root_path):
        for name in files:
            src = os.path.join(root, name)
            stem, ext = os.path.splitext(
                os.path.join(out_root, os.path.relpath(src, root_path))
            )
            dst = stem + ".jpg"
            if ext.lower() not in IMAGE_EXTS or os.path.exists(dst):
                continue
            pairs.append((src, dst))
    return pairs


def _init_worker(args):
    global _worker_landmarker, _worker_args
    from vtoonify_tpu_torch.pipeline.landmarks import (
        DlibLandmarker,
        StaticLandmarker,
    )

    _worker_args = args
    if args.landmarks is not None:
        _worker_landmarker = StaticLandmarker(args.landmarks)
    else:
        _worker_landmarker = DlibLandmarker(args.landmark_model)


def _align_one(pair):
    import cv2
    import numpy as np

    from vtoonify_tpu_torch.pipeline import crop as crop_mod

    src, dst = pair
    try:
        img = cv2.imread(src)
        if img is None:
            return (src, "unreadable")
        frame = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        aligned = crop_mod.align_face(frame, _worker_landmarker,
                                      output_size=_worker_args.output_size)
        if aligned is None:
            return (src, "no face")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        cv2.imwrite(dst, cv2.cvtColor(np.asarray(aligned), cv2.COLOR_RGB2BGR))
        return (src, "ok")
    except Exception as e:  # keep going like the reference (:174-176)
        return (src, f"error: {e}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    pairs = list_pending(args.root_path)
    print(f"Running on {len(pairs)} paths")
    t0 = time.time()
    if args.num_threads <= 1:
        _init_worker(args)
        results = [_align_one(p) for p in pairs]
    else:
        chunk = int(math.ceil(len(pairs) / args.num_threads)) or 1
        # spawn, not fork: the caller may hold jax/torch thread pools
        with mp.get_context("spawn").Pool(
                args.num_threads, initializer=_init_worker,
                initargs=(args,)) as pool:
            results = pool.map(_align_one, pairs, chunksize=chunk)
    ok = sum(1 for _, s in results if s == "ok")
    for src, s in results:
        if s != "ok":
            print(f"skip {src}: {s}")
    print(f"aligned {ok}/{len(pairs)} in {time.time() - t0:.1f}s")
    # console-script wrappers pass the return value to sys.exit(): return a
    # real status code, not the aligned count
    return 0 if ok == len(pairs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
