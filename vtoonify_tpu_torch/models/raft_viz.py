"""Optical-flow color coding and the directory flow demo (port of
vtoonify_tpu/models/raft_viz.py).

The Middlebury flow color wheel (Baker et al., "A Database and Evaluation
Methodology for Optical Flow", ICCV 2007) with the floor and interpolation
conventions of the visualizer the reference vendors
(model/raft/core/utils/flow_viz.py:21-132), host numpy; and a headless
equivalent of the reference's demo script (model/raft/demo.py:41-62):
consecutive frames of a directory -> RAFT flow -> the color-coded flow
stacked under the source frame, written to files. The demo runs RAFT on the
card unless --cpu.

Flow arrays here are (H, W, 2) with (u, v) = (x, y) displacement.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

# (segment length, held-at-255 channel, ramped channel, ramp ascending?)
# — the six hue arcs R→Y→G→C→B→M→R with Scharstein's unequal lengths.
_WHEEL_SEGMENTS = (
    (15, 0, 1, True),   # R held, G rises  (red → yellow)
    (6, 1, 0, False),   # G held, R falls  (yellow → green)
    (4, 1, 2, True),    # G held, B rises  (green → cyan)
    (11, 2, 1, False),  # B held, G falls  (cyan → blue)
    (13, 2, 0, True),   # B held, R rises  (blue → magenta)
    (6, 0, 2, False),   # R held, B falls  (magenta → red)
)


def make_colorwheel() -> np.ndarray:
    """(55, 3) float64 wheel in [0, 255], Scharstein's floor quantization."""
    rows = []
    for length, hold, ramp, ascending in _WHEEL_SEGMENTS:
        seg = np.zeros((length, 3))
        seg[:, hold] = 255.0
        r = np.floor(255.0 * np.arange(length) / length)
        seg[:, ramp] = r if ascending else 255.0 - r
        rows.append(seg)
    return np.concatenate(rows, axis=0)


def colorize_flow_uv(u: np.ndarray, v: np.ndarray,
                     bgr: bool = False) -> np.ndarray:
    """Color-code pre-normalized flow components (radius 1 = saturated).

    Radii ≤ 1 desaturate toward white at the center; radii > 1 are dimmed to
    75% (the out-of-range convention).
    """
    wheel = make_colorwheel() / 255.0
    ncols = wheel.shape[0]
    rad = np.sqrt(np.square(u) + np.square(v))
    fk = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = np.where(k0 + 1 == ncols, 0, k0 + 1)
    f = (fk - k0)[..., None]
    col = (1.0 - f) * wheel[k0] + f * wheel[k1]
    inside = (rad <= 1.0)[..., None]
    col = np.where(inside, 1.0 - rad[..., None] * (1.0 - col), 0.75 * col)
    img = np.floor(255.0 * col).astype(np.uint8)
    return img[..., ::-1] if bgr else img


def flow_to_image(flow: np.ndarray, clip_flow: Optional[float] = None,
                  bgr: bool = False) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 visualization.

    Normalizes by the max radius in the field (so the brightest pixel is the
    largest motion), exactly like the vendored visualizer's `flow_to_image`.
    """
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"expected (H, W, 2) flow, got {flow.shape}")
    flow = np.asarray(flow, np.float64)
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad_max = float(np.sqrt(np.square(u) + np.square(v)).max())
    scale = 1.0 / (rad_max + 1e-5)
    return colorize_flow_uv(u * scale, v * scale, bgr=bgr)


def list_image_pairs(image_dir: str) -> List[tuple]:
    """Sorted consecutive (*.png|*.jpg) pairs, demo.py:50-55 semantics."""
    images = sorted(
        glob.glob(os.path.join(image_dir, "*.png"))
        + glob.glob(os.path.join(image_dir, "*.jpg"))
    )
    return list(zip(images[:-1], images[1:]))


def demo_directory(raft, image_dir: str, out_dir: str, iters: int = 20,
                   cfg=None, device=None) -> List[str]:
    """Flow between each consecutive frame pair of `image_dir` with the RAFT
    module `raft` (on `device`: None is the card); writes [frame; flow-viz]
    stacks as PNGs into out_dir. Returns the written paths."""
    import copy

    import torch
    from PIL import Image

    from vtoonify_tpu_torch import resolve_device
    from vtoonify_tpu_torch.models.raft import RAFTConfig, raft_apply
    from vtoonify_tpu_torch.models.raft_data import InputPadder

    cfg = cfg or RAFTConfig()
    dev = resolve_device(device)
    raft = copy.deepcopy(raft).to(dev, torch.float32)
    os.makedirs(out_dir, exist_ok=True)

    def load(path):
        img = np.array(Image.open(path).convert("RGB"), np.uint8)
        return img, torch.from_numpy(img).to(dev).permute(2, 0, 1)[None].float()

    written = []
    for idx, (path1, path2) in enumerate(list_image_pairs(image_dir)):
        img1, x1 = load(path1)
        _, x2 = load(path2)
        padder = InputPadder(x1.shape, mode="sintel")
        x1, x2 = padder.pad(x1, x2)
        with torch.inference_mode():
            _, flow_up = raft_apply(raft, x1, x2, cfg, iters=iters, test_mode=True)
        flow = padder.unpad(flow_up)[0].permute(1, 2, 0).cpu().numpy()
        stack = np.concatenate([img1, flow_to_image(flow)], axis=0)
        out_path = os.path.join(out_dir, f"flow_{idx:04d}.png")
        Image.fromarray(stack).save(out_path)
        written.append(out_path)
    return written


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="RAFT flow demo over a frame "
                                            "directory (PyTorch + CUDA)")
    p.add_argument("--model", type=str, required=True,
                   help="raft-things.pth (reference torch checkpoint)")
    p.add_argument("--path", type=str, required=True,
                   help="directory of *.png/*.jpg frames")
    p.add_argument("--out", type=str, default="./output/raft_demo")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    from vtoonify_tpu_torch import resolve_device
    from vtoonify_tpu_torch.utils.checkpoint import load_reference_raft

    device = "cpu" if args.cpu else None
    resolve_device(device)  # no card: raise before loading anything
    paths = demo_directory(load_reference_raft(args.model), args.path, args.out,
                           iters=args.iters, device=device)
    print(f"wrote {len(paths)} flow visualizations to {args.out}")


if __name__ == "__main__":
    main()
