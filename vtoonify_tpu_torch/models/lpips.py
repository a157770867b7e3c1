"""LPIPS perceptual distance, net-lin with a VGG16 backbone (port of
vtoonify_tpu/models/lpips.py: `init_lpips`, `lpips_apply`,
`find_lin_weights`, `load_lpips`, `convert_lpips`, `convert_lpips_lins`).

reference model/stylegan/lpips/networks_basic.py:27-110: input scaling ->
VGG16 taps (relu1_2/2_2/3_3/4_3/5_3) -> unit-normalize over channels ->
squared difference -> learned 1x1 `lin` heads -> spatial mean, summed over
the five taps. NCHW; plain PyTorch (cuDNN on the card).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vtoonify_tpu_torch.convert.from_jax import load_jax_params
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops.interp import max_pool

# VGG16 conv channel plan per stage (taps after each stage's last relu)
_VGG_PLAN = ((3, 64, 64), (64, 128, 128), (128, 256, 256, 256),
             (256, 512, 512, 512), (512, 512, 512, 512))
SCALE_SHIFT = (-0.030, -0.088, -0.188)
SCALE_SCALE = (0.458, 0.448, 0.450)


class LinHead(nn.Module):
    def __init__(self, ch, generator=None):
        super().__init__()
        self.weight = L._param(torch.rand((1, ch, 1, 1), generator=generator))


class LPIPS(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.vgg = nn.ModuleList([
            nn.ModuleList([L.Conv2dTorch(st[i], st[i + 1], 3, generator=g)
                           for i in range(len(st) - 1)])
            for st in _VGG_PLAN])
        self.lins = nn.ModuleList([LinHead(st[-1], generator=g) for st in _VGG_PLAN])


def init_lpips(generator=None) -> LPIPS:
    return LPIPS(generator)


def _vgg_features(p: LPIPS, x):
    feats = []
    h = x
    for si, stage in enumerate(p.vgg):
        if si > 0:
            h = max_pool(h, 2)
        for conv in stage:
            h = F.relu(L.conv2d_torch(conv, h, padding=1))
        feats.append(h)
    return feats


def _unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x.square(), dim=1, keepdim=True)) + eps)


def lpips_apply(p: LPIPS, x0, x1):
    """(B, 3, H, W) pairs in [-1, 1] -> (B, 1, 1, 1) distances."""
    shift = torch.tensor(SCALE_SHIFT, dtype=x0.dtype, device=x0.device)[None, :, None, None]
    scale = torch.tensor(SCALE_SCALE, dtype=x0.dtype, device=x0.device)[None, :, None, None]
    f0 = _vgg_features(p, (x0 - shift) / scale)
    f1 = _vgg_features(p, (x1 - shift) / scale)
    val = 0.0
    for a, b, lin in zip(f0, f1, p.lins):
        diff = (_unit_normalize(a) - _unit_normalize(b)).square()
        val = val + F.conv2d(diff, lin.weight.to(diff.dtype)).mean(dim=(2, 3), keepdim=True)
    return val


# ---------------------------------------------------------------------------
# weights for training (reference dist_model.py:24-117: torchvision VGG16 and
# the learned lin heads the reference vendors in-repo)


def find_lin_weights(lin_path=None):
    """The LPIPS lin-head weights file: `lin_path`, else $VTOONIFY_LPIPS_LIN,
    the first that exists; None when neither does."""
    for c in (lin_path, os.environ.get("VTOONIFY_LPIPS_LIN")):
        if c and os.path.exists(c):
            return c
    return None


def _numpy_state(path):
    return {k: v.numpy() for k, v in
            torch.load(path, map_location="cpu", weights_only=True).items()}


def convert_lpips_lins(lin_sd):
    """LPIPS `lin{k}.model.1.weight` (1, C, 1, 1) dict -> the `lins` list of
    the JAX-layout tree."""
    return [{"weight": np.ascontiguousarray(np.transpose(
        lin_sd[f"lin{k}.model.1.weight"], (2, 3, 1, 0)), dtype=np.float32)}
        for k in range(5)]


# torchvision vgg16 `features` indices of the convs of each stage
_VGG_FEATURES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def convert_lpips(vgg_sd, lin_sd):
    """A torchvision vgg16 state dict (`features.*`) and the lin-head dict
    -> the JAX-layout tree `load_jax_params` takes."""
    vgg = [[{"weight": np.ascontiguousarray(np.transpose(
                vgg_sd[f"features.{i}.weight"], (2, 3, 1, 0)), dtype=np.float32),
             "bias": np.asarray(vgg_sd[f"features.{i}.bias"], np.float32)}
            for i in stage] for stage in _VGG_FEATURES]
    return {"vgg": vgg, "lins": convert_lpips_lins(lin_sd)}


def load_lpips(vgg_path=None, lin_path=None, allow_random: bool = False,
               generator=None):
    """(LPIPS on the CPU, a description of its weights) for training.

    The reference always trains against pretrained LPIPS; random perceptual
    weights silently corrupt one of the G losses, so a missing `vgg_path`
    raises unless `allow_random` (--allow_random_lpips) says otherwise. The
    lin heads come from `find_lin_weights(lin_path)`."""
    lin_file = find_lin_weights(lin_path)
    if vgg_path is None:
        if not allow_random:
            raise ValueError(
                "LPIPS needs pretrained VGG16 conv weights: pass --vgg_path "
                "(a torchvision vgg16 state_dict). To knowingly train with a "
                "random perceptual net (tests/smoke only), pass "
                "--allow_random_lpips.")
        net = init_lpips(generator if generator is not None
                         else torch.Generator().manual_seed(1))
        if lin_file is None:
            return net, "fully random (allow_random_lpips)"
        lin_sd = _numpy_state(lin_file)
        with torch.no_grad():
            for k, lin in enumerate(net.lins):  # (1, C, 1, 1) as stored
                lin.weight.copy_(torch.from_numpy(lin_sd[f"lin{k}.model.1.weight"]))
        return net, f"random VGG16 + real lin heads ({lin_file})"
    if lin_file is None:
        raise ValueError(
            "LPIPS lin-head weights not found: pass --lpips_lin_path or set "
            "$VTOONIFY_LPIPS_LIN (the reference vendors them at "
            "model/stylegan/lpips/weights/v0.1/vgg.pth).")
    tree = convert_lpips(_numpy_state(vgg_path), _numpy_state(lin_file))
    net = load_jax_params(init_lpips(torch.Generator().manual_seed(0)), tree)
    return net, f"VGG16 {vgg_path} + lin heads {lin_file}"
