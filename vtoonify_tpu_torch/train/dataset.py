"""Packed image datasets (port of vtoonify_tpu/train/dataset.py).

    python -m vtoonify_tpu_torch.train.dataset faces/ --out packed \
        --size 256,1024

The reference's model/stylegan/dataset.py:8-40 + prepare_data.py (StyleGAN2
heritage; the VToonify trainers synthesize their data and do not read it).
In place of LMDB, images are packed into per-resolution uint8 .npy shards
with a meta.json, in the JAX package's layout (either package reads the
other's shards), memory-mapped, and served as float32 NCHW batches in
[-1, 1] with an epoch-shuffled index, sharded by process.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


def prepare_data(image_paths: Sequence[str], out_dir: str,
                 sizes: Sequence[int] = (128, 256, 512, 1024),
                 shard_size: int = 1024) -> None:
    """Resize-and-pack images into per-resolution uint8 shards
    (reference prepare_data.py equivalent; LANCZOS like the original)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    meta = {"sizes": list(sizes), "count": len(image_paths),
            "shard_size": shard_size}
    for size in sizes:
        buf = []
        shard_idx = 0
        for p in image_paths:
            img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LANCZOS4)
            buf.append(img)
            if len(buf) == shard_size:
                np.save(os.path.join(out_dir, f"{size}-{shard_idx:05d}.npy"),
                        np.stack(buf))
                buf, shard_idx = [], shard_idx + 1
        if buf:
            np.save(os.path.join(out_dir, f"{size}-{shard_idx:05d}.npy"),
                    np.stack(buf))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


class MultiResolutionDataset:
    """Memory-mapped packed image dataset (reference dataset.py:8-40
    equivalent): items are (H, W, 3) uint8 arrays, `batches` yields float32
    (B, 3, H, W) CPU tensors in [-1, 1]."""

    def __init__(self, path: str, resolution: int = 256):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        assert resolution in self.meta["sizes"], "resolution not packed"
        self.resolution = resolution
        self.shards = []
        i = 0
        while True:
            p = os.path.join(path, f"{resolution}-{i:05d}.npy")
            if not os.path.exists(p):
                break
            self.shards.append(np.load(p, mmap_mode="r"))
            i += 1
        self.lengths = [len(s) for s in self.shards]
        self.total = sum(self.lengths)

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, idx: int) -> np.ndarray:
        for s, n in zip(self.shards, self.lengths):
            if idx < n:
                return np.asarray(s[idx])
            idx -= n
        raise IndexError(idx)

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True,
                process_index: int = 0, process_count: int = 1,
                epochs: Optional[int] = None) -> Iterator[torch.Tensor]:
        """Epoch-shuffled, process-sharded batch iterator (replaces
        DistributedSampler, reference util.py:38-46): each epoch shuffles
        the whole index, takes every process_count-th entry from
        process_index and, with drop_last, drops the partial batch."""
        rng = np.random.RandomState(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            idx = np.arange(self.total)
            if shuffle:
                rng.shuffle(idx)
            idx = idx[process_index::process_count]
            stop = len(idx) - (len(idx) % batch_size if drop_last else 0)
            for i in range(0, stop, batch_size):
                batch = np.stack([self[j] for j in idx[i:i + batch_size]])
                batch = torch.from_numpy(batch).permute(0, 3, 1, 2).float()
                yield batch / 127.5 - 1.0
            epoch += 1


def main(argv=None):
    """CLI equivalent of the reference prepare_data.py (model/stylegan/
    prepare_data.py:1-50): walk an image directory, resize-and-pack every
    image at the requested sizes into per-resolution shards."""
    import argparse

    p = argparse.ArgumentParser(
        description="Pack an image folder into per-resolution uint8 shards "
                    "for MultiResolutionDataset")
    p.add_argument("path", help="directory of images (walked recursively)")
    p.add_argument("--out", required=True, help="output shard directory")
    p.add_argument("--size", type=str, default="128,256,512,1024",
                   help="comma-separated square resolutions to pack")
    p.add_argument("--shard_size", type=int, default=1024,
                   help="images per .npy shard")
    args = p.parse_args(argv)

    exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
    paths = sorted(
        os.path.join(root, f)
        for root, _, files in os.walk(args.path)
        for f in files
        if os.path.splitext(f)[1].lower() in exts
    )
    if not paths:
        raise SystemExit(f"no images found under {args.path}")
    sizes = [int(s) for s in args.size.split(",")]
    print(f"packing {len(paths)} images at sizes {sizes} -> {args.out}")
    prepare_data(paths, args.out, sizes=sizes, shard_size=args.shard_size)
    print("done")


if __name__ == "__main__":
    main()
