"""The per-frame toonification graph + pipeline object (port of
vtoonify_tpu/pipeline/toonify.py: `frame_graph`, `frame_graph_with_parsing`,
`ToonifyPipeline` with `compute_style`, `process_batch`,
`process_batch_with_parsing` / `process_image`, `unpack_frame`, size
bucketing and packed output).

The public frame API keeps the JAX package's layout: uint8 (B, H, W, 3) in,
uint8 (B, 4H, 4W, 3) out, or with `packed_output` (B, 2H, 2W, 12)
phase-major, which `unpack_frame` finishes on the host. Inside, activations
are NCHW. Compute dtype is bfloat16 by default; the modules are cast once
when the pipeline is built. Style preparation (pSp encoder, mapping MLP,
exemplar splice) runs in float32 whatever the compute dtype. The pipeline
runs on the card unless it is built with `device="cpu"`. With a `mesh`
(parallel/mesh.py::make_mesh) it keeps one copy of the modules per dp row
of the mesh and splits each batch's frames over them (frame-parallel
serving), the wide VToonify weights of a row split over its 'tp' devices
(`parallel.tensor`); with a spatial mesh (`make_spatial_mesh`) it splits
each frame's rows over the devices instead, and the graph runs on row slabs
(`parallel.spatial`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from vtoonify_tpu_torch import resolve_device
from vtoonify_tpu_torch.models.bisenet import bisenet_apply
from vtoonify_tpu_torch.models.generator import style_mlp
from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, psp_encoder_apply
from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig, vtoonify_apply
from vtoonify_tpu_torch.ops.interp import resize_bilinear, resize_nearest
from vtoonify_tpu_torch.parallel import spatial

PARSING_WEIGHT = 1.0 / 16.0  # reference style_transfer.py:174


def _normalize(frames_u8, dtype):
    """uint8 NHWC -> [-1, 1] NCHW in the compute dtype (the JAX order:
    cast, divide, subtract, all in `dtype`)."""
    return frames_u8.permute(0, 3, 1, 2).to(dtype) / 127.5 - 1.0


def _to_bytes(out, packed):
    """(B, 3, 4H, 4W) uint8 -> NHWC (B, 4H, 4W, 3), or with `packed` the
    phase-major (B, 2H, 2W, 12) layout, out[b, 2i+a, 2j+c', ch] at channel
    (2a+c')*3 + ch: one permutation of the bytes either way. (The JAX
    package's packed synthesis stages are TPU layouts and are not ported;
    the port is held to the bytes.) Row slabs are packed slab by slab, split
    at even rows first."""
    if not packed:
        return out.permute(0, 2, 3, 1).contiguous()
    if isinstance(out, spatial.RowSharded):
        return spatial.aligned(out, 2).map_slabs(lambda t: _to_bytes(t, True), axis=1,
                                                 scale=(1, 2))
    b, c, h, w = out.shape
    return (out.view(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 3, 5, 1)
            .reshape(b, h // 2, w // 2, 4 * c))


def _stylize(vt, vt_cfg, x, x_p, s_w, d_s, dtype):
    inputs = torch.cat([x, x_p.to(dtype) * PARSING_WEIGHT], dim=1)
    # a batch-1 style (one style code per video) is NOT broadcast to the
    # frame batch: the modulated convs fold it into their kernels
    s_w_b = s_w.to(dtype)
    if s_w_b.ndim == 2:
        s_w_b = s_w_b[None]
    return vtoonify_apply(vt, vt_cfg, inputs, s_w_b, d_s=d_s)


def _quantize(y, packed=False):
    y = torch.clamp(y, -1.0, 1.0)
    # round half to even, in float32, as the JAX graph quantizes
    out = torch.round((y.float() + 1.0) * 127.5).to(torch.uint8)
    return _to_bytes(out, packed)


def stylized_image(vt, vt_cfg: VToonifyConfig, parsing, frames_u8, s_w, d_s,
                   dtype=torch.bfloat16):
    """frame_graph before its clamp and quantization: the (B, 3, 4H, 4W)
    image out of `vtoonify_apply`, in `dtype`."""
    x = _normalize(frames_u8, dtype)
    h, w = x.shape[2:]
    x2 = resize_bilinear(x, (2 * h, 2 * w), align_corners=False)
    logits = bisenet_apply(parsing, 2.0 * x2)
    x_p = resize_nearest(logits, (h, w))
    return _stylize(vt, vt_cfg, x, x_p, s_w, d_s, dtype)


def frame_graph(vt, vt_cfg: VToonifyConfig, parsing, frames_u8, s_w, d_s,
                dtype=torch.bfloat16, packed_out: bool = False):
    """uint8 frames (B, H, W, 3) -> stylized uint8 (B, 4H, 4W, 3), or
    (B, 2H, 2W, 12) phase-major with `packed_out`. The frames may be row
    slabs (`parallel.spatial.RowSharded`, NHWC rows on axis 1); so is the
    output then.

    reference style_transfer.py:165-177: BiSeNet on the 2x bilinear-upsampled
    frame (x2 gain), nearest x0.5 downsample of the logits, 1/16-weighted
    concat, VToonify forward, clamp, quantize."""
    return _quantize(stylized_image(vt, vt_cfg, parsing, frames_u8, s_w, d_s, dtype),
                     packed_out)


def frame_graph_with_parsing(vt, vt_cfg: VToonifyConfig, frames_u8, x_p, s_w,
                             d_s, dtype=torch.bfloat16, packed_out: bool = False):
    """frame_graph with precomputed parsing maps x_p (B, H, W, 19)."""
    x = _normalize(frames_u8, dtype)
    return _quantize(_stylize(vt, vt_cfg, x, x_p.permute(0, 3, 1, 2), s_w, d_s, dtype),
                     packed_out)


class ToonifyPipeline:
    """Programmatic API over the per-frame graph.

    Holds copies of the modules cast to the compute dtype on `device`
    (None: the card, `cuda`; raises when there is none — pass "cpu" to run
    on the CPU), and float32 copies of what style preparation reads: the
    pSp encoder and the generator's mapping MLP (not the whole VToonify).
    Style codes are computed once per image/video (`compute_style`) and
    frozen; pass them to `process_batch` as (1, n_latent, 512).

    size_bucket: round each frame's H and W up to a multiple of it with a
    reflect pad on the host, and crop the output back. Not bit-exact:
    BiSeNet's global pools and the fusion's instance norms see the padding.
    bucket_margin (with size_bucket): reflect-pad this many more pixels on
    every side first and crop them from the output too, which moves the
    padding's halo out of the kept region. packed_output: `process_batch`
    returns (B, 2H, 2W, 12) phase-major uint8; `unpack_frame` finishes it
    (the video writer and `process_image` do so).

    mesh: a `parallel.mesh.Mesh`; one copy of the VToonify model (its
    mapping MLP included) and of BiSeNet per dp row of the mesh, in the
    compute dtype, on the row's first device. `process_batch` and
    `process_batch_with_parsing` split the frames over the rows (a batch
    the mesh does not divide is refused), launch every chunk before waiting
    on any and return the frames in order on the first device. Style
    preparation runs on the first device, on the unsplit float32 mapping
    MLP. A row's frames are the numbers one device gives for those frames in
    one call (a one-frame share takes the unfolded style form, as a batch of
    one does). With `tp` > 1 (`make_mesh(n, tp=k)`) the row's VToonify holds
    its wide weights split over the row's k devices (JAX's rule, `min_channels`
    256): each wide layer runs an output-channel slab on each of them and
    gathers the slabs on the row's first device; BiSeNet stays whole there.
    A spatial mesh (`make_spatial_mesh`) splits each frame's rows over its
    devices instead, for any batch: the modules stay on the first device
    with a registered copy on each other one (`parallel.spatial.replicate`),
    the graph runs on row slabs, exchanging halo rows and summing its global
    means over them, and the output rows are gathered on the first device.
    """

    def __init__(self, vt, vt_cfg: VToonifyConfig, parsing, psp_params=None,
                 psp_cfg=None, latent_avg=None, exstyle=None,
                 dtype=torch.bfloat16, mesh=None, size_bucket=None,
                 packed_output: bool = False, bucket_margin: int = 0,
                 device=None):
        """psp_params: a port `PSPEncoder`; latent_avg: its (n_styles, 512)
        mean code; exstyle: the exemplar's z+ code (1, n_latent, 512),
        before `zplus2wplus`."""
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"ToonifyPipeline: device {device} is not the "
                                 f"mesh's first device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.vt_cfg = vt_cfg
        self.size_bucket = size_bucket
        self.bucket_margin = bucket_margin
        self.packed_output = packed_output
        self.dtype = dtype
        self.device = resolve_device(device)
        self.vt = copy.deepcopy(vt).to(self.device, dtype)
        self.parsing = copy.deepcopy(parsing).to(self.device, dtype)
        # (device, vt, parsing) per dp row; the first is the pipeline's own
        self._replicas = [(self.device, self.vt, self.parsing)]
        self._spatial = mesh is not None and mesh.axis == "sp"
        if self._spatial:
            self._sp_copies = (spatial.replicate(self.vt, mesh.devices)
                               + spatial.replicate(self.parsing, mesh.devices))
        elif mesh is not None:
            from vtoonify_tpu_torch.parallel.tensor import shard_module

            first, *rest = mesh.rows
            for row in rest:  # each row's first device, its wide weights split over the row
                self._replicas.append((row[0], shard_module(copy.deepcopy(self.vt), row),
                                       copy.deepcopy(self.parsing).to(row[0])))
            shard_module(self.vt, first)
        gp = vt.generator.generator if vt_cfg.backbone == "dualstylegan" else vt.generator
        self._mapping = nn.Module()  # holds `style`, all that style_mlp reads
        self._mapping.style = copy.deepcopy(gp.style).to(self.device, torch.float32)
        self.psp = (None if psp_params is None else
                    copy.deepcopy(psp_params).to(self.device, torch.float32))
        self.psp_cfg = psp_cfg or PSPEncoderConfig()
        self.latent_avg = (None if latent_avg is None else torch.as_tensor(
            latent_avg, dtype=torch.float32, device=self.device))
        self.exstyle_w = None
        if exstyle is not None:
            self.exstyle_w = self._zplus2wplus(torch.as_tensor(
                exstyle, dtype=torch.float32, device=self.device))

    def _zplus2wplus(self, zplus):
        """models/vtoonify.py::zplus2wplus on the float32 mapping MLP."""
        nb, nl, nd = zplus.shape
        with torch.inference_mode():
            return style_mlp(self._mapping, self.vt_cfg.generator,
                             zplus.reshape(nb * nl, nd)).reshape(zplus.shape)

    def compute_style(self, aligned_face_u8, color_transfer: bool = False):
        """Aligned 256x256 uint8 face -> frozen per-video style code s_w
        (1, n_latent, 512), float32 on the device.

        reference style_transfer.py:140-149: pSp z+ -> w+, then splice the
        exemplar (dualstylegan backbone only): its layers :7 (structure), or
        all of it with `color_transfer`."""
        if self.psp is None:
            raise RuntimeError("pipeline built without a pSp encoder")
        face = torch.as_tensor(np.array(aligned_face_u8, np.uint8), device=self.device)
        x = face.permute(2, 0, 1)[None].float() / 127.5 - 1.0
        with torch.inference_mode():
            zp = psp_encoder_apply(self.psp, self.psp_cfg, x,
                                   latent_avg=self.latent_avg)
        s_w = self._zplus2wplus(zp)
        if self.vt_cfg.backbone == "dualstylegan" and self.exstyle_w is not None:
            if color_transfer:
                return self.exstyle_w
            s_w = torch.cat([self.exstyle_w[:, :7], s_w[:, 7:]], dim=1)
        return s_w

    @staticmethod
    def unpack_frame(packed_u8: np.ndarray, bgr: bool = False) -> np.ndarray:
        """The host finish of packed_output: (2H, 2W, 12) uint8 phase-major
        -> (4H, 4W, 3) RGB (or BGR for encoders), one native pass."""
        from vtoonify_tpu_torch import native

        return native.depth_to_space2_u8(np.asarray(packed_u8), bgr=bgr)

    def process_batch(self, frames_u8, s_w, d_s: float):
        """(B, H, W, 3) uint8 -> (B, 4H, 4W, 3) uint8 tensor on the device
        (asynchronous, like the JAX device array), or (B, 2H, 2W, 12) with
        packed_output. s_w: numpy or tensor."""
        frames_u8 = np.asarray(frames_u8)
        pad_h = pad_w = 0
        mg = self.bucket_margin if self.size_bucket else 0
        if self.size_bucket:
            m = self.size_bucket
            if mg:
                frames_u8 = np.pad(frames_u8, ((0, 0), (mg, mg), (mg, mg), (0, 0)),
                                   mode="reflect")
            h, w = frames_u8.shape[1:3]
            pad_h, pad_w = (-h) % m, (-w) % m
            if pad_h or pad_w:
                frames_u8 = np.pad(frames_u8, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)),
                                   mode="reflect")
        out = self._run(lambda vt, parsing, f, sw: frame_graph(
            vt, self.vt_cfg, parsing, f, sw, float(d_s), self.dtype,
            self.packed_output), s_w, frames_u8)
        if pad_h or pad_w or mg:
            s = 2 if self.packed_output else 4  # a packed row covers 2 pixels
            oh = out.shape[1] - s * (pad_h + mg)
            ow = out.shape[2] - s * (pad_w + mg)
            out = out[:, s * mg:oh, s * mg:ow]
        return out

    def process_batch_with_parsing(self, frames_u8, x_p, s_w, d_s: float):
        """process_batch with precomputed parsing maps x_p (B, H, W, 19)."""
        return self._run(lambda vt, parsing, f, sw, p: frame_graph_with_parsing(
            vt, self.vt_cfg, f, p, sw, float(d_s), self.dtype,
            self.packed_output), s_w, np.asarray(frames_u8), x_p)

    def _run(self, graph, s_w, *batches):
        """graph(vt, parsing, frames, s_w, *rest) on each replica's share of
        `batches` = (frames, *rest) (host arrays or tensors, frame axis first): every
        chunk is uploaded and launched before any is waited on; the outputs
        are concatenated in frame order on the first device. Over a spatial
        mesh the graph runs once on every batch's row slabs and its output
        rows are gathered on the first device."""
        if self._spatial:
            from vtoonify_tpu_torch.parallel.mesh import shard_array_spatial

            slabs = [shard_array_spatial(b, self.mesh) for b in batches]
            with torch.inference_mode():
                sw = torch.as_tensor(s_w, dtype=torch.float32, device=self.device)
                out = graph(self.vt, self.parsing, slabs[0], sw, *slabs[1:])
            return spatial.gather(out, self.device)
        if len(self._replicas) == 1:
            rows = [slice(None)]
        else:
            from vtoonify_tpu_torch.parallel.mesh import shard_batch

            rows = shard_batch(self.mesh, len(batches[0]))
        chunks = [[torch.as_tensor(b[r], device=dev) for b in batches]
                  for r, (dev, _, _) in zip(rows, self._replicas)]
        outs = []
        with torch.inference_mode():
            for (dev, vt, parsing), c in zip(self._replicas, chunks):
                sw = torch.as_tensor(s_w, dtype=torch.float32, device=dev)
                with spatial.on_device(dev):  # each replica's kernels on its card
                    outs.append(graph(vt, parsing, c[0], sw, *c[1:]))
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])

    def process_image(self, frame_u8, s_w, d_s: float) -> np.ndarray:
        out = self.process_batch(np.asarray(frame_u8)[None], s_w, d_s)[0].cpu().numpy()
        if self.packed_output:
            out = self.unpack_frame(out)
        return out
