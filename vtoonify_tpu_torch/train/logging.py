"""Training observability: fixed-sample image grids and a loss history
(port of vtoonify_tpu/train/logging.py: `to_uint8`, `save_image_grid`,
`MetricsLogger`, `SampleGridLogger`).

The reference saves a fixed-input sample grid to log/NAME/%05d.jpg every
`log_every` iterations, seeding the fixed pair at iteration 0
(train_vtoonify_d.py:271-276, 361-376). `SampleGridLogger` freezes one
synthesized (input, target, style, degree) tuple and renders the EMA
student on it below the target; `MetricsLogger` appends one JSON line of
scalar losses per logged step.
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from vtoonify_tpu_torch.models.vtoonify import vtoonify_apply
from vtoonify_tpu_torch.ops.interp import avg_pool, resize_bilinear


def to_uint8(img) -> np.ndarray:
    """[-1, 1] floats -> uint8 as torchvision's save_image rounds
    (mul(255).add_(0.5).clamp_(0, 255).byte(): round half up, which np.round
    is not)."""
    x = (np.asarray(img, np.float32) + 1.0) * 127.5 + 0.5
    return np.floor(np.clip(x, 0, 255)).astype(np.uint8)


def save_image_grid(path: str, images, nrow: int, pad: int = 2) -> None:
    """Tile (N, 3, H, W) images in [-1, 1] into a grid jpg, `nrow` a row
    (torchvision's save_image layout: black padding between cells)."""
    from PIL import Image

    imgs = np.moveaxis(to_uint8(images), 1, -1)
    n, h, w = imgs.shape[:3]
    nr = (n + nrow - 1) // nrow
    grid = np.zeros((nr * h + pad * (nr + 1), nrow * w + pad * (nrow + 1), 3),
                    np.uint8)
    for i in range(n):
        r, c = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + c * (w + pad)
        grid[y:y + h, x:x + w] = imgs[i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path, quality=92)


class MetricsLogger:
    """Appends one JSON line per logged step to LOG_DIR/metrics.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, **extra) -> None:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        rec.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _to_256(y):
    if y.shape[2] > 256:
        return avg_pool(y, y.shape[2] // 256)
    return resize_bilinear(y, (256, 256)) if y.shape[2] < 256 else y


class SampleGridLogger:
    """Fixed-sample grids (reference train_vtoonify_d.py:271-276, 361-376).

    `seed(batch_data, d_s)` keeps the first (real_input, real_output, xl,
    d_s) it is given; `log(step, modules, d_s_now)` renders rows [target,
    student(fixed d_s), student(d_s_now) when the degree varies] at 256 px
    to LOG_DIR/%05d.jpg. `modules` maps VToonify's child names to modules
    (the frozen backbone and the EMA trainables). VToonify-T has no degree
    (`use_degree=False`): one rendered row (train_vtoonify_t.py:295-303)."""

    def __init__(self, log_dir: str, cfg, fix_degree: bool,
                 use_degree: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.cfg = cfg
        self.use_degree = use_degree
        self.fix_degree = fix_degree or not use_degree
        self._fixed = None

    def seed(self, batch_data: dict, d_s) -> None:
        if self._fixed is not None:
            return
        self._fixed = {
            "in": batch_data["real_input"].detach().float(),
            "out": _to_256(batch_data["real_output"].detach().float()).cpu(),
            "xl": batch_data["xl"].detach().float(),
            "d_s": float(d_s),
        }

    @torch.no_grad()
    def _render(self, modules, d_s):
        f = self._fixed
        vt = SimpleNamespace(**modules)
        dev = next(modules["encoder"].parameters()).device
        out = vtoonify_apply(vt, self.cfg, f["in"].to(dev), f["xl"].to(dev),
                             d_s if self.use_degree else None)
        return _to_256(torch.clamp(out, -1.0, 1.0)).float().cpu()

    def log(self, step: int, modules: dict, d_s_now) -> str:
        assert self._fixed is not None, "seed() must run at iteration 0"
        rows = [self._fixed["out"], self._render(modules, self._fixed["d_s"])]
        if not self.fix_degree:
            rows.append(self._render(modules, float(d_s_now)))
        path = os.path.join(self.log_dir, f"{step:05d}.jpg")
        save_image_grid(path, torch.cat(rows).numpy(),
                        nrow=self._fixed["out"].shape[0])
        return path
