"""Offline parsing-map smoothing with RAFT optical flow (port of
vtoonify_tpu/pipeline/smooth_parsing.py: `warp_backward`, `_pad_div8` /
`_unpad`, `fuse_window`, `smooth_video_parsing_maps`, `main`).

Reference smooth_parsing_map.py: frames are 2x upsampled, BiSeNet parses
each frame, and for each frame a +-window temporal neighbourhood is aligned
to it by RAFT flow (20 iterations) and fused with spatial x temporal
Gaussian weights; the fused maps are 2x downsampled (kernel B3) and saved
as `<basename>_parsingmap.npy`, which the style-transfer CLI reads with
--parsing_map_path. Each window's K = 2·window+1 flow pairs run as one
batch. Runs on the card unless `device="cpu"` (--cpu). Inputs, weights,
activations and maps are float32; on the card the convolutions and matmuls
run in TF32 unless `tf32=False` (--fp32), which is full float32 and ~20x
slower (cuDNN then picks FFT algorithms for RAFT's 3x3 convs; PERF.md).
"""

from __future__ import annotations

import contextlib
import copy
import os

import numpy as np
import torch
import torch.nn.functional as F

from vtoonify_tpu_torch import resolve_device
from vtoonify_tpu_torch.models.bisenet import bisenet_apply
from vtoonify_tpu_torch.models.raft import RAFTConfig, raft_apply
from vtoonify_tpu_torch.nn.layers import BLUR_KERNEL, _blur_1d
from vtoonify_tpu_torch.ops.interp import grid_sample, resize_bilinear
from vtoonify_tpu_torch.ops.upfirdn2d import downsample_2x

# the [1, 3, 3, 1] taps, a host constant built once: B3 takes them by value
BLUR_1D = _blur_1d(BLUR_KERNEL)


def warp_backward(x, flow):
    """Backward-warp x (B, C, H, W) by flow (B, 2, H, W); returns (warped,
    mask) (reference smooth_parsing_map.py:38-74: align_corners=True, zero
    padding, the validity mask binarized at 0.9999)."""
    b, _, h, w = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    gx = 2.0 * (xs + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys + flow[:, 1]) / max(h - 1, 1) - 1.0
    vgrid = torch.stack([gx, gy], dim=-1)
    out = grid_sample(x, vgrid, align_corners=True, padding_mode="zeros")
    mask = grid_sample(torch.ones_like(x[:, :1]), vgrid, align_corners=True,
                       padding_mode="zeros")
    mask = (mask >= 0.9999).to(x.dtype)
    return out * mask, mask


def _pad_div8(x):
    """InputPadder 'sintel' mode: replicate-pad H, W up to /8, floor/ceil."""
    h, w = x.shape[2:]
    ph, pw = (-h) % 8, (-w) % 8
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                 mode="replicate"), (ph, pw)


def _unpad(x, ph_pw):
    ph, pw = ph_pw
    h, w = x.shape[2:]
    return x[:, :, ph // 2: h - (ph - ph // 2), pw // 2: w - (pw - pw // 2)]


def fuse_window(raft, frames_win, parses_win, center: int, iters: int = 20,
                sigma_s: float = 0.2, alt_corr: bool = False):
    """Fuse one temporal window of K frames onto its center frame.

    frames_win: (K, 3, H, W) in [-1, 1] (2x upsampled); parses_win:
    (K, 19, H, W). Returns the fused (1, 19, H/2, W/2) map (downsampled)."""
    k = frames_win.shape[0]
    window = center
    image1 = frames_win[center][None].expand_as(frames_win)
    image1p, pads = _pad_div8(image1)
    image2p, _ = _pad_div8(frames_win)
    _, flow_up = raft_apply(
        raft, (image1p + 1) * 255.0 / 2, (image2p + 1) * 255.0 / 2,
        RAFTConfig(corr_impl="alt" if alt_corr else "allpairs"),
        iters=iters, test_mode=True)
    flow_up = _unpad(flow_up, pads)

    output, mask = warp_backward(torch.cat([frames_win, parses_win], dim=1), flow_up)
    aligned_is = output[:, 0:3]
    aligned_ps = output[:, 3:].clone()
    ws = torch.exp(
        -torch.mean(torch.square(aligned_is - frames_win[center][None]), dim=1,
                    keepdim=True) / (2 * sigma_s ** 2)) * mask[:, 0:1]
    aligned_ps[window] = parses_win[center]
    ws[window] = 1.0
    wt = torch.exp(
        -torch.square(torch.arange(k, dtype=torch.float32, device=ws.device) - window)
        / (2 * (window + 0.5) ** 2)).reshape(k, 1, 1, 1)
    weights = ws * wt
    weights = weights / torch.sum(weights, dim=0, keepdim=True)
    fused = torch.sum(aligned_ps * weights, dim=0, keepdim=True)
    return downsample_2x(fused, BLUR_1D)


@contextlib.contextmanager
def float32_precision(tf32: bool):
    """TF32 on (True) or off for cuDNN's convolutions and for matmuls while
    the block runs; the flags are restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def window_indices(n: int, window: int) -> np.ndarray:
    """(n, 2·window+1): the frames of each frame's window. The sequence ends
    are padded with the first / last `window` frames (reference :129,
    :138), indices as a JAX gather takes them."""
    idx = np.concatenate([np.arange(window), np.arange(n), np.arange(n - window, n)])
    idx = np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)
    return np.stack([idx[i: i + 2 * window + 1] for i in range(n)])


def prepare_frames(parsing, frames_u8, dev):
    """(N, H, W, 3) uint8 -> the 2x upsampled frames (N, 3, 2H, 2W) in
    [-1, 1] and their BiSeNet parses (N, 19, 2H, 2W), on `dev`."""
    frames = torch.as_tensor(np.asarray(frames_u8), device=dev).permute(
        0, 3, 1, 2).float() / 127.5 - 1.0
    n, _, h, w = frames.shape
    frames2x = resize_bilinear(frames, (2 * h, 2 * w), align_corners=False)
    del frames
    parses = torch.cat([bisenet_apply(parsing, 2.0 * frames2x[i:i + 1])
                        for i in range(n)], dim=0)
    return frames2x, parses


def smooth_video_parsing_maps(raft, parsing, frames_u8, window: int = 5,
                              iters: int = 20, progress=None,
                              alt_corr: bool = False, device=None,
                              tf32: bool = True):
    """frames_u8: (N, H, W, 3) uint8 video frames -> (N, H, W, 19) float32
    smoothed parsing maps, numpy (frames are 2x upsampled inside, fused at
    2x, then downsampled back; reference smooth_parsing_map.py:127-166).

    raft / parsing: the port's RAFT and BiSeNet modules; float32 copies run
    on `device` (None: the card). alt_corr: RAFT's on-the-fly correlation;
    the 2x frames make the all-pairs volume the smoother's largest buffer
    at HD inputs (a 2160x3840 fused frame has 130k pixels at 1/8 scale: a
    67 GB volume per pair; the alt path needs ~130 MB). tf32: on the card,
    cuDNN's convolutions and the matmuls in TF32 (False: full float32)."""
    dev = resolve_device(device)
    raft = copy.deepcopy(raft).to(dev, torch.float32)
    parsing = copy.deepcopy(parsing).to(dev, torch.float32)
    with float32_precision(tf32), torch.inference_mode():
        frames2x, parses = prepare_frames(parsing, frames_u8, dev)
        windows = torch.as_tensor(window_indices(frames2x.shape[0], window), device=dev)
        out = []
        rng = range(frames2x.shape[0])
        if progress is not None:
            rng = progress(rng)
        for ii in rng:
            sel = windows[ii]
            fused = fuse_window(raft, frames2x[sel], parses[sel], center=window,
                                iters=iters, alt_corr=alt_corr)
            out.append(fused[0].permute(1, 2, 0).cpu().numpy())
    return np.stack(out)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Smooth Parsing Maps (PyTorch + CUDA)")
    p.add_argument("--window_size", type=int, default=5)
    p.add_argument("--faceparsing_path", type=str,
                   default="./checkpoint/faceparsing.pth")
    p.add_argument("--raft_path", type=str,
                   default="./checkpoint/raft-things.pth")
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--output_path", type=str, default="./output/")
    p.add_argument("--alt_corr", action="store_true",
                   help="memory-efficient on-the-fly RAFT correlation "
                        "(for HD inputs whose all-pairs volume exceeds memory)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--fp32", action="store_true",
                   help="full float32 on the card: TF32 off for cuDNN's "
                        "convolutions and matmuls (~20x slower)")
    args = p.parse_args(argv)

    from vtoonify_tpu_torch.pipeline.video import iterate_video_frames
    from vtoonify_tpu_torch.utils import checkpoint as ckpt_util

    device = "cpu" if args.cpu else None
    resolve_device(device)  # no card: raise before loading anything
    raft = ckpt_util.load_reference_raft(args.raft_path)
    parsing = ckpt_util.load_reference_faceparsing(args.faceparsing_path)
    frames = np.stack([f for _, f in iterate_video_frames(args.video_path)])
    maps = smooth_video_parsing_maps(raft, parsing, frames, window=args.window_size,
                                     alt_corr=args.alt_corr, device=device,
                                     tf32=not args.fp32)
    basename = os.path.basename(args.video_path).split(".")[0]
    np.save(os.path.join(args.output_path, basename + "_parsingmap.npy"), maps)
    print("Done!")


if __name__ == "__main__":
    main()
