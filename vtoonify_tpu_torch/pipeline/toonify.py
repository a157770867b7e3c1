"""The per-frame toonification graph + pipeline object (port of
vtoonify_tpu/pipeline/toonify.py: `frame_graph`, `frame_graph_with_parsing`,
`ToonifyPipeline` with `process_batch` / `process_image`).

The public frame API keeps the JAX package's layout: uint8 (B, H, W, 3) in,
uint8 (B, 4H, 4W, 3) out. Inside, activations are NCHW. Compute dtype is
bfloat16 by default; the modules are cast once when the pipeline is built.
The pipeline runs on the card unless it is built with `device="cpu"`.
Not ported yet: style preparation (`compute_style`, pSp, the exemplar
style), size bucketing, packed output and device meshes; asking for one
raises NotImplementedError.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from vtoonify_tpu_torch import resolve_device
from vtoonify_tpu_torch.models.bisenet import bisenet_apply
from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig, vtoonify_apply
from vtoonify_tpu_torch.ops.interp import resize_bilinear, resize_nearest

PARSING_WEIGHT = 1.0 / 16.0  # reference style_transfer.py:174


def _normalize(frames_u8, dtype):
    """uint8 NHWC -> [-1, 1] NCHW in the compute dtype (the JAX order:
    cast, divide, subtract, all in `dtype`)."""
    return frames_u8.permute(0, 3, 1, 2).to(dtype) / 127.5 - 1.0


def _synthesize(vt, vt_cfg, x, x_p, s_w, d_s, dtype):
    inputs = torch.cat([x, x_p.to(dtype) * PARSING_WEIGHT], dim=1)
    # a batch-1 style (one style code per video) is NOT broadcast to the
    # frame batch: the modulated convs fold it into their kernels
    s_w_b = s_w.to(dtype)
    if s_w_b.ndim == 2:
        s_w_b = s_w_b[None]
    y = vtoonify_apply(vt, vt_cfg, inputs, s_w_b, d_s=d_s)
    y = torch.clamp(y, -1.0, 1.0)
    # round half to even, in float32, as the JAX graph quantizes
    out = torch.round((y.float() + 1.0) * 127.5).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous()


def frame_graph(vt, vt_cfg: VToonifyConfig, parsing, frames_u8, s_w, d_s,
                dtype=torch.bfloat16):
    """uint8 frames (B, H, W, 3) -> stylized uint8 (B, 4H, 4W, 3).

    reference style_transfer.py:165-177: BiSeNet on the 2x bilinear-upsampled
    frame (x2 gain), nearest x0.5 downsample of the logits, 1/16-weighted
    concat, VToonify forward, clamp, quantize."""
    x = _normalize(frames_u8, dtype)
    h, w = x.shape[2:]
    x2 = resize_bilinear(x, (2 * h, 2 * w), align_corners=False)
    logits = bisenet_apply(parsing, 2.0 * x2)
    x_p = resize_nearest(logits, (h, w))
    return _synthesize(vt, vt_cfg, x, x_p, s_w, d_s, dtype)


def frame_graph_with_parsing(vt, vt_cfg: VToonifyConfig, frames_u8, x_p, s_w,
                             d_s, dtype=torch.bfloat16):
    """frame_graph with precomputed parsing maps x_p (B, H, W, 19)."""
    x = _normalize(frames_u8, dtype)
    return _synthesize(vt, vt_cfg, x, x_p.permute(0, 3, 1, 2), s_w, d_s, dtype)


class ToonifyPipeline:
    """Programmatic API over the per-frame graph.

    Holds copies of the modules cast to the compute dtype on `device`
    (None: the card, `cuda`; raises when there is none — pass "cpu" to run
    on the CPU). Style codes are computed once per image/video and frozen;
    pass them to `process_batch` as (1, n_latent, 512).
    """

    def __init__(self, vt, vt_cfg: VToonifyConfig, parsing, psp_params=None,
                 psp_cfg=None, latent_avg=None, exstyle=None,
                 dtype=torch.bfloat16, mesh=None, size_bucket=None,
                 packed_output: bool = False, bucket_margin: int = 0,
                 device=None):
        unported = {"psp_params": psp_params, "psp_cfg": psp_cfg,
                    "latent_avg": latent_avg, "exstyle": exstyle, "mesh": mesh,
                    "size_bucket": size_bucket,
                    "packed_output": packed_output or None,
                    "bucket_margin": bucket_margin or None}
        asked = [k for k, v in unported.items() if v is not None]
        if asked:
            raise NotImplementedError(f"ToonifyPipeline: {', '.join(asked)} "
                                      "not ported yet")
        self.vt_cfg = vt_cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.vt = copy.deepcopy(vt).to(self.device, dtype)
        self.parsing = copy.deepcopy(parsing).to(self.device, dtype)

    def compute_style(self, aligned_face_u8, color_transfer: bool = False):
        raise NotImplementedError("compute_style needs the pSp encoder, which "
                                  "is not ported yet")

    def process_batch(self, frames_u8, s_w, d_s: float):
        """(B, H, W, 3) uint8 -> (B, 4H, 4W, 3) uint8 tensor on the device
        (asynchronous, like the JAX device array). s_w: numpy or tensor."""
        frames = torch.as_tensor(np.asarray(frames_u8), device=self.device)
        s_w = torch.as_tensor(s_w, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return frame_graph(self.vt, self.vt_cfg, self.parsing, frames, s_w,
                               float(d_s), self.dtype)

    def process_image(self, frame_u8, s_w, d_s: float) -> np.ndarray:
        return self.process_batch(np.asarray(frame_u8)[None], s_w, d_s)[0].cpu().numpy()
