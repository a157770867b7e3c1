"""RAFT training (port of vtoonify_tpu/models/raft_train.py: the sequence
loss, the OneCycle schedule, the clipped AdamW step, the host augmentors,
the dataset indexes, the batch iterator and the `vtoonify-raft-train`
command).

    python -m vtoonify_tpu_torch.models.raft_train --stage chairs \\
        --validation chairs --data_root datasets [--cpu]

Reference model/raft/train.py + core/utils/augmentor.py + core/datasets.py
(upstream tooling vendored by VToonify). One step (`raft_train_step`) runs
the forward over every refinement iteration, the sequence loss, a global-
norm clip over the trainable parameters and AdamW under the OneCycle
schedule, on the device of the state's model. Batch norm follows the
reference's staging (train.py:146-147): the context encoder normalizes with
batch statistics and updates its running buffers in place on 'chairs'
(`RaftTrainConfig.train_bn`, set by the CLI), and uses its running
statistics, frozen, on every later stage; the affine weights train in both.
The stochastic augmentation stays on the host in numpy/cv2 (the port's own
copy of the JAX package's, so one seed gives the same crops), as the
reference keeps it in its DataLoader workers.

The command runs on the card unless --cpu (raises without one); there its
convolutions and matmuls run in TF32 (with TF32 off cuDNN picks FFT
algorithms for RAFT's 3x3 convs, 10-20x slower), and --mixed_precision runs
the forward under bfloat16 autocast with float32 master weights (no loss
scaler: bfloat16 keeps float32's exponent range).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vtoonify_tpu_torch import resolve_device
from vtoonify_tpu_torch.models.raft import RAFT, RAFTConfig, raft_apply
from vtoonify_tpu_torch.models.raft_data import read_flow_file
from vtoonify_tpu_torch.nn.layers import set_trainable

MAX_FLOW = 400.0  # exclude extreme displacements (train.py:41)


# --- loss (train.py sequence_loss, :47-73) -------------------------------------


def sequence_loss(flow_preds: Sequence[torch.Tensor], flow_gt, valid,
                  gamma: float = 0.8, max_flow: float = MAX_FLOW):
    """Exponentially weighted L1 over the refinement sequence.

    flow_preds: list of (B, 2, H, W); flow_gt (B, 2, H, W); valid (B, H, W).
    As the reference: each iteration's term averages the masked L1 over ALL
    pixels (invalid ones add zero to the sum only), the EPE metrics average
    over valid pixels. Computed in float32 (float64 for a float64 model)."""
    n = len(flow_preds)
    dt = torch.promote_types(flow_preds[-1].dtype, torch.float32)
    flow_gt = flow_gt.to(dt)
    mag = torch.sqrt(torch.sum(torch.square(flow_gt), dim=1))
    valid = (valid >= 0.5) & (mag < max_flow)
    vf = valid.to(dt)
    vmask = vf[:, None]

    loss = torch.zeros((), dtype=dt, device=flow_gt.device)
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - i - 1)
        loss = loss + w * torch.mean(vmask * torch.abs(pred.to(dt) - flow_gt))

    epe = torch.sqrt(torch.sum(torch.square(flow_preds[-1].to(dt) - flow_gt), dim=1))
    denom = torch.clamp(torch.sum(vf), min=1.0)

    def vmean(x):
        return torch.sum(x.to(dt) * vf) / denom

    metrics = {"epe": vmean(epe), "1px": vmean(epe < 1), "3px": vmean(epe < 3),
               "5px": vmean(epe < 5)}
    return loss, metrics


# --- optimizer (train.py fetch_optimizer, :79-86) -------------------------------


def onecycle_linear_lr(lr: float, num_steps: int, pct_start: float = 0.05,
                       div_factor: float = 25.0, final_div_factor: float = 1e4):
    """torch OneCycleLR(anneal_strategy='linear', cycle_momentum=False) as a
    function of the step count: linear lr/div_factor -> lr over the first
    pct_start, then linear decay to (lr/div_factor)/final_div_factor. The
    peak is reached at step pct_start*total - 1, the floor at total - 1
    (OneCycleLR._schedule_phases). The reference schedules over
    num_steps + 100, so training never reaches the floor."""
    warm = pct_start * num_steps - 1
    last = num_steps - 1
    init = lr / div_factor
    final = init / final_div_factor

    def schedule(step: int) -> float:
        if step <= warm:
            return init + (lr - init) * step / max(warm, 1.0)
        return lr + (final - lr) * (step - warm) / max(last - warm, 1.0)

    return schedule


class RaftTrainConfig(NamedTuple):
    lr: float = 2e-5
    num_steps: int = 100000
    wdecay: float = 5e-5
    epsilon: float = 1e-8
    clip: float = 1.0           # global-norm gradient clip (train.py:176)
    gamma: float = 0.8          # sequence-loss weighting
    iters: int = 12             # refinement iterations during training
    add_noise: bool = False     # per-batch U[0,5]-stdev gaussian (train.py:166)
    train_bn: bool = False      # batch-stats BN + running-buffer updates: the
    # reference trains BN on 'chairs' and freezes it for every later stage
    # (train.py:146-147); the CLI sets this per stage
    mixed_precision: bool = False  # the forward under bfloat16 autocast


def make_raft_optimizer(params, tcfg: RaftTrainConfig) -> torch.optim.AdamW:
    """AdamW(0.9, 0.999, eps, decoupled weight decay) over `params`, the
    trainable parameters; `raft_train_step` sets its learning rate from
    `onecycle_linear_lr` before each update. torch's AdamW decays by
    lr * wdecay * p before the Adam step, optax's adamw adds wdecay * p to
    the Adam direction and scales the sum by lr: the same update, at the
    same step's learning rate."""
    return torch.optim.AdamW(params, lr=tcfg.lr, betas=(0.9, 0.999),
                             eps=tcfg.epsilon, weight_decay=tcfg.wdecay)


@dataclass
class RaftTrainState:
    model: RAFT                 # float32 master weights; BN running buffers
    opt: torch.optim.AdamW      # over the trainable parameters only
    step: int = 0


def init_raft_train_state(model: RAFT, tcfg: RaftTrainConfig,
                          device=None) -> RaftTrainState:
    """Moves `model` to `device` (None: the card; raises without one), marks
    its parameters trainable and builds AdamW over them. The batch norms'
    running buffers are buffers: never optimized, never in the clip's norm."""
    model.to(resolve_device(device))
    set_trainable(model)
    return RaftTrainState(model=model, opt=make_raft_optimizer(model.parameters(), tcfg))


@dataclass
class RaftTrainDraws:
    """Every random value of one step: the input noise of --add_noise."""
    stdv: torch.Tensor          # () the noise's standard deviation, U[0, 5)
    noise1: torch.Tensor        # (B, 3, H, W) standard normal, image 1
    noise2: torch.Tensor        # ... image 2

    def to(self, device):
        return RaftTrainDraws(*(t.to(device) for t in (self.stdv, self.noise1,
                                                      self.noise2)))


def sample_raft_train_draws(generator: Optional[torch.Generator], shape,
                            device=None) -> RaftTrainDraws:
    """Draw one step's values from `generator` (on its device) for images
    of `shape` (B, 3, H, W), then move them to `device`."""
    gdev = generator.device if generator is not None else device
    stdv = torch.rand((), generator=generator, device=gdev) * 5.0
    noise1 = torch.randn(tuple(shape), generator=generator, device=gdev)
    noise2 = torch.randn(tuple(shape), generator=generator, device=gdev)
    return RaftTrainDraws(stdv, noise1, noise2).to(device)


def _clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm in place: scale by max_norm / norm when the
    norm reaches max_norm, decided on the device (no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def raft_train_step(state: RaftTrainState, image1, image2, flow_gt, valid,
                    cfg: RAFTConfig, tcfg: RaftTrainConfig,
                    draws: Optional[RaftTrainDraws] = None,
                    generator: Optional[torch.Generator] = None) -> dict:
    """One iteration (train.py:160-182): [noise] -> forward over all
    iterations -> sequence loss -> clipped AdamW update at the schedule's
    learning rate for `state.step`. images (B, 3, H, W) in [0, 255], flow_gt
    (B, 2, H, W), valid (B, H, W), moved to the model's device. The noise
    comes from `draws`, else from `generator`. Mutates `state` (with
    train_bn, the BN running buffers too); returns {loss, epe, 1px, 3px,
    5px} as device tensors."""
    model, opt = state.model, state.opt
    dev = next(model.parameters()).device
    image1, image2, flow_gt, valid = (t.to(dev) for t in (image1, image2, flow_gt, valid))
    if tcfg.add_noise:
        if draws is None:
            draws = sample_raft_train_draws(generator, image1.shape, dev)
        draws = draws.to(dev)
        image1 = torch.clamp(image1 + draws.stdv * draws.noise1, 0.0, 255.0)
        image2 = torch.clamp(image2 + draws.stdv * draws.noise2, 0.0, 255.0)

    lr = onecycle_linear_lr(tcfg.lr, tcfg.num_steps + 100)(state.step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    with torch.autocast(dev.type, torch.bfloat16, enabled=tcfg.mixed_precision):
        preds = raft_apply(model, image1, image2, cfg, iters=tcfg.iters,
                           test_mode=False, train_bn=tcfg.train_bn)
    loss, metrics = sequence_loss(preds, flow_gt, valid, gamma=tcfg.gamma)
    loss.backward()
    _clip_by_global_norm([p.grad for g in opt.param_groups for p in g["params"]
                          if p.grad is not None], tcfg.clip)
    opt.step()
    state.step += 1
    return {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}


# --- host-side augmentation (core/utils/augmentor.py) -------------------------

_GRAY = np.array([0.2989, 0.587, 0.114])


def _color_jitter(rng: np.random.RandomState, img: np.ndarray,
                  brightness: float, contrast: float, saturation: float,
                  hue: float) -> np.ndarray:
    """torchvision ColorJitter semantics in numpy/cv2: uniform factors, the
    four adjustments applied in a random order."""
    import cv2

    out = img.astype(np.float32)
    ops = rng.permutation(4)
    for op in ops:
        if op == 0 and brightness > 0:
            f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
            out = out * f
        elif op == 1 and contrast > 0:
            f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
            mean = (out @ _GRAY).mean()
            out = f * out + (1 - f) * mean
        elif op == 2 and saturation > 0:
            f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
            gray = (out @ _GRAY)[..., None]
            out = f * out + (1 - f) * gray
        elif op == 3 and hue > 0:
            f = rng.uniform(-hue, hue)  # fraction of the full circle
            hsv = cv2.cvtColor(
                np.clip(out, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
            h = hsv[..., 0].astype(np.int32) + int(round(f * 180.0))
            hsv[..., 0] = np.mod(h, 180).astype(np.uint8)
            out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)
        out = np.clip(out, 0, 255)
    return out.astype(np.uint8)


class FlowAugmentor:
    """Dense-flow augmentation (augmentor.py:15-120): photometric jitter
    (asymmetric 20% of the time), occlusion eraser on frame 2, random
    scale/stretch, h/v flips with flow-sign fixes, fixed-size crop."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=True, seed: Optional[int] = None):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.jitter = (0.4, 0.4, 0.4, 0.5 / 3.14)
        self.rng = np.random.RandomState(seed)

    def color_transform(self, img1, img2):
        if self.rng.rand() < self.asymmetric_color_aug_prob:
            img1 = _color_jitter(self.rng, img1, *self.jitter)
            img2 = _color_jitter(self.rng, img2, *self.jitter)
        else:
            stack = _color_jitter(self.rng, np.concatenate([img1, img2], 0),
                                  *self.jitter)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if self.rng.rand() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(self.rng.randint(1, 3)):
                x0 = self.rng.randint(0, wd)
                y0 = self.rng.randint(0, ht)
                dx = self.rng.randint(bounds[0], bounds[1])
                dy = self.rng.randint(bounds[0], bounds[1])
                img2[y0:y0 + dy, x0:x0 + dx] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow):
        import cv2

        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if self.rng.rand() < self.stretch_prob:
            sx *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
        sx, sy = max(sx, min_scale), max(sy, min_scale)

        if self.rng.rand() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            flow = cv2.resize(flow, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR) * [sx, sy]

        if self.do_flip:
            if self.rng.rand() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.rng.rand() < self.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]

        # max(1,·): when the no-resize branch (prob 0.2) leaves the image
        # exactly crop-sized — e.g. FlyingChairs' native 384×512 with
        # --image_size 384 512 — offset 0 is the only valid crop (the
        # upstream augmentor crashes on randint(0, 0) here)
        y0 = self.rng.randint(0, max(1, img1.shape[0] - self.crop_size[0]))
        x0 = self.rng.randint(0, max(1, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow, valid=None):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow = self.spatial_transform(img1, img2, flow)
        img1 = np.ascontiguousarray(img1)
        img2 = np.ascontiguousarray(img2)
        flow = np.ascontiguousarray(flow.astype(np.float32))
        valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        return img1, img2, flow, valid.astype(np.float32)


class SparseFlowAugmentor:
    """Sparse-flow (KITTI/HD1K) variant (augmentor.py:122-238): milder
    jitter, no stretch, nearest-valid-pixel flow-map resize, margin crop."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=False, seed: Optional[int] = None):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.spatial_aug_prob = 0.8
        self.h_flip_prob = 0.5
        self.eraser_aug_prob = 0.5
        self.jitter = (0.3, 0.3, 0.3, 0.3 / 3.14)
        self.rng = np.random.RandomState(seed)

    def color_transform(self, img1, img2):
        stack = _color_jitter(self.rng, np.concatenate([img1, img2], 0),
                              *self.jitter)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2):
        ht, wd = img1.shape[:2]
        if self.rng.rand() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(self.rng.randint(1, 3)):
                x0 = self.rng.randint(0, wd)
                y0 = self.rng.randint(0, ht)
                dx = self.rng.randint(50, 100)
                dy = self.rng.randint(50, 100)
                img2[y0:y0 + dy, x0:x0 + dx] = mean_color
        return img1, img2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)),
                          axis=-1).reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid >= 1]
        flow0 = flow[valid >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

        flow_img = np.zeros((ht1, wd1, 2), np.float32)
        valid_img = np.zeros((ht1, wd1), np.int32)
        flow_img[yy[keep], xx[keep]] = flow1[keep]
        valid_img[yy[keep], xx[keep]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid):
        import cv2

        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht),
                        (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        sx = sy = max(scale, min_scale)

        if self.rng.rand() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            flow, valid = self.resize_sparse_flow_map(flow, valid, sx, sy)

        if self.do_flip and self.rng.rand() < self.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        margin_y, margin_x = 20, 50
        y0 = self.rng.randint(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = self.rng.randint(-margin_x,
                              img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow.astype(np.float32)),
                np.ascontiguousarray(valid.astype(np.float32)))


# --- dataset path indexes (core/datasets.py) ----------------------------------

Entry = Tuple[str, str, str, bool]  # (img1, img2, flow_path, sparse)


def index_sintel(root: str, dstype: str = "clean",
                 split: str = "training") -> List[Entry]:
    img_root = os.path.join(root, split, dstype)
    flow_root = os.path.join(root, split, "flow")
    entries = []
    for scene in sorted(os.listdir(img_root)):
        frames = sorted(os.listdir(os.path.join(img_root, scene)))
        for a, b in zip(frames[:-1], frames[1:]):
            entries.append((
                os.path.join(img_root, scene, a),
                os.path.join(img_root, scene, b),
                os.path.join(flow_root, scene,
                             os.path.splitext(a)[0] + ".flo"),
                False,
            ))
    return entries


def index_flying_chairs(root: str, split: str = "training",
                        split_file: Optional[str] = None) -> List[Entry]:
    """<root>/*.ppm pairs + *.flo; optional chairs_split.txt (1=train,
    2=validation) like datasets.FlyingChairs."""
    import glob as globmod

    images = sorted(globmod.glob(os.path.join(root, "*.ppm")))
    flows = sorted(globmod.glob(os.path.join(root, "*.flo")))
    labels = (np.loadtxt(split_file, dtype=np.int32)
              if split_file else np.ones(len(flows), np.int32))
    want = 1 if split == "training" else 2
    return [
        (images[2 * i], images[2 * i + 1], flows[i], False)
        for i in range(len(flows)) if labels[i] == want
    ]


def index_flying_things(root: str,
                        dstype: str = "frames_cleanpass") -> List[Entry]:
    import glob as globmod

    entries = []
    for direction in ("into_future", "into_past"):
        image_dirs = sorted(
            os.path.join(f, "left")
            for f in globmod.glob(os.path.join(root, dstype, "TRAIN/*/*")))
        flow_dirs = sorted(
            os.path.join(f, direction, "left")
            for f in globmod.glob(os.path.join(root,
                                               "optical_flow/TRAIN/*/*")))
        for idir, fdir in zip(image_dirs, flow_dirs):
            images = sorted(globmod.glob(os.path.join(idir, "*.png")))
            flows = sorted(globmod.glob(os.path.join(fdir, "*.pfm")))
            for i in range(len(flows) - 1):
                if direction == "into_future":
                    entries.append((images[i], images[i + 1], flows[i], False))
                else:
                    entries.append((images[i + 1], images[i], flows[i + 1],
                                    False))
    return entries


def index_kitti(root: str, split: str = "training") -> List[Entry]:
    img_root = os.path.join(root, split, "image_2")
    flow_root = os.path.join(root, split, "flow_occ")
    ids = sorted({f[:6] for f in os.listdir(img_root)})
    return [
        (os.path.join(img_root, f"{i}_10.png"),
         os.path.join(img_root, f"{i}_11.png"),
         os.path.join(flow_root, f"{i}_10.png"), True)
        for i in ids
    ]


def index_hd1k(root: str) -> List[Entry]:
    import glob as globmod

    entries = []
    seq = 0
    while True:
        flows = sorted(globmod.glob(os.path.join(
            root, "hd1k_flow_gt", "flow_occ", f"{seq:06d}_*.png")))
        images = sorted(globmod.glob(os.path.join(
            root, "hd1k_input", "image_2", f"{seq:06d}_*.png")))
        if not flows:
            break
        for i in range(len(flows) - 1):
            entries.append((images[i], images[i + 1], flows[i], True))
        seq += 1
    return entries


def fetch_stage(stage: str, image_size, roots: dict, seed: int = 0):
    """(entry, augmentor) list mirroring datasets.fetch_dataloader:199-236 —
    per-sub-dataset augmentation parameters and the C+T+K+S+H sampling
    weights. `roots` maps dataset name → directory."""
    items = []

    def add(entries, aug, weight=1):
        items.extend([(e, aug) for e in entries] * weight)

    if stage == "chairs":
        aug = FlowAugmentor(image_size, -0.1, 1.0, True, seed)
        add(index_flying_chairs(roots["chairs"], "training",
                                roots.get("chairs_split")), aug)
    elif stage == "things":
        aug = FlowAugmentor(image_size, -0.4, 0.8, True, seed)
        add(index_flying_things(roots["things"], "frames_cleanpass"), aug)
        add(index_flying_things(roots["things"], "frames_finalpass"), aug)
    elif stage == "sintel":
        aug = FlowAugmentor(image_size, -0.2, 0.6, True, seed)
        add(index_flying_things(roots["things"], "frames_cleanpass"), aug)
        add(index_sintel(roots["sintel"], "clean"), aug, weight=100)
        add(index_sintel(roots["sintel"], "final"), aug, weight=100)
        if "kitti" in roots:
            add(index_kitti(roots["kitti"]),
                SparseFlowAugmentor(image_size, -0.3, 0.5, True, seed),
                weight=200)
        if "hd1k" in roots:
            add(index_hd1k(roots["hd1k"]),
                SparseFlowAugmentor(image_size, -0.5, 0.2, True, seed),
                weight=5)
    elif stage == "kitti":
        aug = SparseFlowAugmentor(image_size, -0.2, 0.4, False, seed)
        add(index_kitti(roots["kitti"]), aug)
    else:
        raise ValueError(f"unknown stage: {stage}")
    return items


def load_entry(entry: Entry):
    """(img1, img2, flow, valid|None) uint8/float32 arrays from paths."""
    import cv2

    i1p, i2p, fp, sparse = entry
    img1 = cv2.cvtColor(cv2.imread(i1p), cv2.COLOR_BGR2RGB)
    img2 = cv2.cvtColor(cv2.imread(i2p), cv2.COLOR_BGR2RGB)
    flow, valid = read_flow_file(fp)
    if sparse and valid is None:
        raise ValueError(f"sparse entry without a valid mask: {fp}")
    return img1, img2, flow.astype(np.float32), valid


def batch_iterator(items, batch_size: int, seed: int = 0):
    """Infinite shuffled epochs of augmented fixed-shape batches
    (the DataLoader(shuffle=True, drop_last=True) analogue). Yields
    (image1, image2, flow, valid) float32/float32 NHWC stacks."""
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(len(items))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            b1, b2, bf, bv = [], [], [], []
            for j in order[s:s + batch_size]:
                entry, aug = items[j]
                img1, img2, flow, valid = load_entry(entry)
                if valid is not None:
                    img1, img2, flow, valid = aug(img1, img2, flow, valid)
                else:
                    img1, img2, flow, valid = aug(img1, img2, flow)
                b1.append(img1)
                b2.append(img2)
                bf.append(flow)
                bv.append(valid)
            yield (np.stack(b1).astype(np.float32),
                   np.stack(b2).astype(np.float32),
                   np.stack(bf), np.stack(bv).astype(np.float32))


# --- CLI (train.py:216-245) -----------------------------------------------------


def _upload(batch, dev):
    """The iterator's NHWC numpy batch -> NCHW float32 tensors on `dev`."""
    img1, img2, flow, valid = (torch.from_numpy(a).to(dev) for a in batch)
    return (img1.permute(0, 3, 1, 2).contiguous(), img2.permute(0, 3, 1, 2).contiguous(),
            flow.permute(0, 3, 1, 2).contiguous(), valid)


def _save(model, path):
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def main(argv=None):
    """Train RAFT on one stage. Writes checkpoints/{step}_{name}.ckpt every
    --val_freq steps (then runs --validation) and checkpoints/{name}.ckpt
    at the end (torch.save of the RAFT state dict; --restore_ckpt reads it
    back, so stages chain as in the reference's train_standard.sh). Returns
    {"checkpoint": the final file, "step_seconds": each step's host wall}."""
    import argparse
    import time

    p = argparse.ArgumentParser(description="Train RAFT (PyTorch + CUDA)")
    p.add_argument("--name", default="raft")
    p.add_argument("--stage", required=True,
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--restore_ckpt", default=None,
                   help="checkpoint to start from: a reference RAFT .pth/.pt "
                        "or a .ckpt saved by this trainer, so the reference's "
                        "train_standard.sh stage chaining works with either")
    p.add_argument("--mixed_precision", action="store_true",
                   help="the forward under bfloat16 autocast, float32 master "
                        "weights, no loss scaler")
    p.add_argument("--validation", type=str, nargs="+", default=[])
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--image_size", type=int, nargs=2, default=[384, 512])
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--wdecay", type=float, default=5e-5)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--freeze_bn", dest="freeze_bn", action="store_true",
                   default=None,
                   help="force running-stats BN; default follows the "
                        "reference (train BN on 'chairs', frozen after)")
    p.add_argument("--train_bn", dest="freeze_bn", action="store_false",
                   help="force batch-stats BN on any stage")
    p.add_argument("--data_root", type=str, default="datasets",
                   help="directory holding Sintel/ KITTI/ FlyingChairs_release/"
                        " FlyingThings3D/ HD1k/ trees")
    p.add_argument("--val_freq", type=int, default=5000)
    p.add_argument("--alt_corr", action="store_true",
                   help="memory-efficient on-the-fly correlation (reference "
                        "alt_cuda_corr equivalent); exact, trades compute "
                        "for the O((H*W)^2) volume's memory")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    from vtoonify_tpu_torch.models import raft_data as RD
    from vtoonify_tpu_torch.models.raft import init_raft
    from vtoonify_tpu_torch.pipeline.smooth_parsing import float32_precision
    from vtoonify_tpu_torch.utils.checkpoint import load_reference_raft

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = RAFTConfig(corr_impl="alt" if args.alt_corr else "allpairs")
    freeze_bn = args.stage != "chairs" if args.freeze_bn is None else args.freeze_bn
    tcfg = RaftTrainConfig(lr=args.lr, num_steps=args.num_steps, wdecay=args.wdecay,
                           epsilon=args.epsilon, clip=args.clip, gamma=args.gamma,
                           iters=args.iters, add_noise=args.add_noise,
                           train_bn=not freeze_bn,
                           mixed_precision=args.mixed_precision)

    if args.restore_ckpt and args.restore_ckpt.endswith(".ckpt"):
        # this trainer's own file (stage chaining a la train_standard.sh:
        # chairs -> things -> sintel -> kitti)
        model = init_raft(cfg, torch.Generator().manual_seed(0))
        model.load_state_dict(torch.load(args.restore_ckpt, map_location="cpu",
                                         weights_only=True))
    elif args.restore_ckpt:
        model = load_reference_raft(args.restore_ckpt, cfg)
    else:
        model = init_raft(cfg, torch.Generator().manual_seed(args.seed))

    roots = {
        "chairs": os.path.join(args.data_root, "FlyingChairs_release/data"),
        "chairs_split": (os.path.join(args.data_root, "chairs_split.txt")
                         if os.path.exists(os.path.join(
                             args.data_root, "chairs_split.txt")) else None),
        "things": os.path.join(args.data_root, "FlyingThings3D"),
        "sintel": os.path.join(args.data_root, "Sintel"),
        "kitti": os.path.join(args.data_root, "KITTI"),
        "hd1k": os.path.join(args.data_root, "HD1k"),
    }
    roots = {k: v for k, v in roots.items()
             if v is not None and (k == "chairs_split" or os.path.isdir(v))}
    items = fetch_stage(args.stage, args.image_size, roots, args.seed)
    print(f"Training with {len(items)} image pairs")

    state = init_raft_train_state(model, tcfg, device=dev)
    generator = torch.Generator(dev).manual_seed(args.seed)
    os.makedirs("checkpoints", exist_ok=True)

    batches = batch_iterator(items, args.batch_size, args.seed)
    running, step_seconds = {}, []
    t0 = time.time()
    with float32_precision(True):  # TF32 on the card
        for step in range(args.num_steps):
            t1 = time.perf_counter()
            metrics = raft_train_step(state, *_upload(next(batches), dev), cfg, tcfg,
                                      generator=generator)
            for k, v in metrics.items():
                running[k] = running.get(k, 0.0) + float(v)
            step_seconds.append(time.perf_counter() - t1)
            if (step + 1) % 100 == 0:
                avg = {k: v / 100 for k, v in running.items()}
                rate = (time.time() - t0) / (step + 1)
                print(f"[{step + 1:6d}] " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(avg.items()))
                    + f" ({rate:.2f} s/it)", flush=True)
                running = {}
            if (step + 1) % args.val_freq == 0 or (step + 1) == args.num_steps:
                _save(state.model, f"checkpoints/{step + 1}_{args.name}.ckpt")
                with torch.autocast(dev.type, torch.bfloat16,
                                    enabled=args.mixed_precision):
                    for val in args.validation:
                        if val == "chairs" and "chairs" in roots:
                            print(RD.validate_chairs(
                                state.model, roots["chairs"],
                                split_file=roots.get("chairs_split"),
                                iters=args.iters, cfg=cfg))
                        elif val == "sintel" and "sintel" in roots:
                            print(RD.validate_sintel(state.model, roots["sintel"],
                                                     iters=args.iters, cfg=cfg))
                        elif val == "kitti" and "kitti" in roots:
                            print(RD.validate_kitti(state.model, roots["kitti"],
                                                    iters=args.iters, cfg=cfg))

    path = f"checkpoints/{args.name}.ckpt"
    _save(state.model, path)
    print(f"saved {path}")
    return {"checkpoint": path, "step_seconds": step_seconds}


if __name__ == "__main__":
    main()
