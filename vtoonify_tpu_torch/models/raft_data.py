"""RAFT data and evaluation plumbing (port of vtoonify_tpu/models/raft_data.py:
the flow-file readers and writers, `InputPadder`, the MPI-Sintel and
KITTI-2015 walkers, the `validate_*` functions, `forward_interpolate` and the
leaderboard submissions).

Reference model/raft/evaluate.py:21-96 and core/utils/{frame_utils,
datasets}.py, vendored from upstream RAFT. The file formats and walkers are
numpy/cv2 host code (the port's own copy); the validators and submissions
run the port's RAFT on the device of the module they are given, on NCHW
tensors, and return what the JAX package's do. Downloads are the caller's
concern: the trees are supplied on disk.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

_FLO_MAGIC = 202021.25  # Middlebury sanity constant


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32 (frame_utils.readFlow)."""
    with open(path, "rb") as f:
        magic = struct.unpack("f", f.read(4))[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = struct.unpack("i", f.read(4))[0]
        h = struct.unpack("i", f.read(4))[0]
        data = np.frombuffer(f.read(4 * 2 * w * h), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """(H, W, 2) float32 -> Middlebury .flo (frame_utils.writeFlow)."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("f", _FLO_MAGIC))
        f.write(struct.pack("i", w))
        f.write(struct.pack("i", h))
        f.write(np.asarray(flow, np.float32).tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Portable FloatMap ('PF' color / 'Pf' gray): a dims line, a scale line
    whose sign gives the byte order, rows stored bottom-up
    (frame_utils.readPFM). FlyingThings3D ships flow as 3-channel PFM."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype=dtype)
    data = data.reshape(h, w, channels) if channels > 1 else data.reshape(h, w)
    return np.flipud(data).astype(np.float32)


def read_flow_file(path: str):
    """(flow (H, W, 2), valid mask or None) by extension: .flo (Middlebury),
    .pfm (FlyingThings, last channel dropped), .png (KITTI sparse 16-bit)."""
    ext = os.path.splitext(path)[1]
    if ext == ".flo":
        return read_flo(path), None
    if ext == ".pfm":
        return read_pfm(path)[:, :, :2], None
    if ext == ".png":
        return read_kitti_flow(path)
    raise ValueError(f"unknown flow format: {path}")


def read_kitti_flow(path: str):
    """KITTI 16-bit png -> ((H, W, 2) flow, (H, W) valid mask)
    (frame_utils.readFlowKITTI: u = (I - 2^15) / 64, channel 3 = valid)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    img = img[:, :, ::-1].astype(np.float32)  # BGR -> RGB channel order
    flow = (img[:, :, :2] - 2 ** 15) / 64.0
    valid = img[:, :, 2] > 0.5
    return flow, valid


def write_kitti_flow(path: str, flow: np.ndarray, valid=None) -> None:
    import cv2

    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), bool)
    out = np.zeros((h, w, 3), np.uint16)
    q = np.clip(flow * 64.0 + 2 ** 15, 0, 2 ** 16 - 1)
    out[:, :, 2] = np.round(q[:, :, 0]).astype(np.uint16)  # BGR file order
    out[:, :, 1] = np.round(q[:, :, 1]).astype(np.uint16)
    out[:, :, 0] = valid.astype(np.uint16)
    cv2.imwrite(path, out)


class InputPadder:
    """Replicate-pad NCHW images so H and W are multiples of 8
    (raft/core/utils/utils.py InputPadder): 'sintel' mode pads both sides
    evenly, any other mode (KITTI's) pads the bottom only in H. `shape` is
    the images' shape, (..., H, W)."""

    def __init__(self, shape, mode: str = "sintel"):
        h, w = shape[-2], shape[-1]
        ph = (-h) % 8
        pw = (-w) % 8
        if mode == "sintel":
            self._pad = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
        else:
            self._pad = (pw // 2, pw - pw // 2, 0, ph)

    def pad(self, *images):
        out = [F.pad(im, self._pad, mode="replicate") for im in images]
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        left, right, top, bottom = self._pad
        h, w = x.shape[-2], x.shape[-1]
        return x[..., top:h - bottom, left:w - right]


def _read_image(path: str) -> np.ndarray:
    import cv2

    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def iter_sintel(root: str, dstype: str = "clean", split: str = "training"):
    """Yield (im1, im2, flow_gt, valid=None) over the MPI-Sintel layout
    <root>/<split>/<dstype>/<scene>/frame_NNNN.png + ../flow/<scene>/*.flo
    (raft datasets.MpiSintel)."""
    img_root = os.path.join(root, split, dstype)
    flow_root = os.path.join(root, split, "flow")
    for scene in sorted(os.listdir(img_root)):
        frames = sorted(os.listdir(os.path.join(img_root, scene)))
        for a, b in zip(frames[:-1], frames[1:]):
            flo = os.path.join(flow_root, scene, os.path.splitext(a)[0] + ".flo")
            yield (_read_image(os.path.join(img_root, scene, a)),
                   _read_image(os.path.join(img_root, scene, b)),
                   read_flo(flo), None)


def iter_kitti(root: str, split: str = "training"):
    """Yield (im1, im2, flow_gt, valid) over the KITTI-2015 layout
    <root>/<split>/image_2/NNNNNN_1{0,1}.png + flow_occ (raft
    datasets.KITTI)."""
    img_root = os.path.join(root, split, "image_2")
    flow_root = os.path.join(root, split, "flow_occ")
    ids = sorted({f[:6] for f in os.listdir(img_root)})
    for i in ids:
        flow, valid = read_kitti_flow(os.path.join(flow_root, f"{i}_10.png"))
        yield (_read_image(os.path.join(img_root, f"{i}_10.png")),
               _read_image(os.path.join(img_root, f"{i}_11.png")),
               flow, valid)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _padded_pair(im1, im2, pad_mode, dev):
    """(H, W, 3) uint8 numpy frames -> the padder and the padded
    (1, 3, H', W') float32 pair on `dev`."""
    padder = InputPadder(im1.shape[:2], mode=pad_mode)
    x1, x2 = (torch.from_numpy(np.ascontiguousarray(im)).to(dev).permute(2, 0, 1)[None]
              .float() for im in (im1, im2))
    return padder, padder.pad(x1, x2)


def _validate(model, pairs, iters, cfg, pad_mode):
    from vtoonify_tpu_torch.models.raft import RAFTConfig, raft_apply
    from vtoonify_tpu_torch.models.raft_eval import end_point_error

    cfg = cfg or RAFTConfig()
    dev = _device_of(model)
    results = []
    with torch.inference_mode():
        for im1, im2, gt, valid in pairs:
            padder, (x1, x2) = _padded_pair(im1, im2, pad_mode, dev)
            _, flow = raft_apply(model, x1, x2, cfg, iters=iters)
            flow = padder.unpad(flow)[0].float()
            gt = torch.from_numpy(np.ascontiguousarray(gt)).to(dev).permute(2, 0, 1)
            results.append(end_point_error(
                flow, gt, None if valid is None else torch.from_numpy(valid).to(dev)))
    return ({k: float(np.mean([r[k] for r in results])) for k in results[0]}
            if results else {})


def validate_sintel(model, root: str, dstype: str = "clean", iters: int = 32,
                    cfg=None):
    """Sintel-train EPE (reference evaluate.py:66-96 validate_sintel)."""
    return _validate(model, iter_sintel(root, dstype), iters, cfg, "sintel")


def validate_kitti(model, root: str, iters: int = 24, cfg=None):
    """KITTI-train EPE, valid-masked (reference evaluate.py validate_kitti)."""
    return _validate(model, iter_kitti(root), iters, cfg, "kitti")


def validate_chairs(model, root: str, split_file=None, iters: int = 24, cfg=None):
    """FlyingChairs validation-split EPE (reference evaluate.py:74-90
    validate_chairs; chairs frames are already multiples of 8, so the
    padder is a no-op)."""
    from vtoonify_tpu_torch.models.raft_train import index_flying_chairs

    def pairs():
        for im1, im2, flo, _ in index_flying_chairs(root, "validation", split_file):
            yield _read_image(im1), _read_image(im2), read_flo(flo), None

    return _validate(model, pairs(), iters, cfg, "sintel")


# --- leaderboard submissions (reference evaluate.py:21-71) ---------------------


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-warp a (H, W, 2) flow field onto the regular grid
    (nearest-neighbour scattered interpolation, zero fill): the reference's
    warm-start propagation (model/raft/core/utils/utils.py:26-54)."""
    from scipy import interpolate

    flow = np.asarray(flow, np.float32)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf, dyf = dx.reshape(-1), dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]
    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest",
                                  fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest",
                                  fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)


def iter_sintel_test(root: str, dstype: str = "clean"):
    """Yield (im1, im2, scene, frame_idx) over the MPI-Sintel TEST layout
    <root>/test/<dstype>/<scene>/frame_NNNN.png (no ground truth)."""
    img_root = os.path.join(root, "test", dstype)
    for scene in sorted(os.listdir(img_root)):
        frames = sorted(os.listdir(os.path.join(img_root, scene)))
        for idx, (a, b) in enumerate(zip(frames[:-1], frames[1:])):
            yield (_read_image(os.path.join(img_root, scene, a)),
                   _read_image(os.path.join(img_root, scene, b)), scene, idx)


def iter_kitti_test(root: str):
    """Yield (im1, im2, file_id) over the KITTI-2015 TESTING layout
    <root>/testing/image_2/NNNNNN_1{0,1}.png (no ground truth)."""
    img_root = os.path.join(root, "testing", "image_2")
    ids = sorted({f[:6] for f in os.listdir(img_root)})
    for i in ids:
        yield (_read_image(os.path.join(img_root, f"{i}_10.png")),
               _read_image(os.path.join(img_root, f"{i}_11.png")), f"{i}_10.png")


def _to_hwc(flow):
    """(1, 2, H, W) tensor -> (H, W, 2) float32 numpy."""
    return flow[0].permute(1, 2, 0).float().cpu().numpy()


def create_sintel_submission(model, root: str, output_path: str, iters: int = 32,
                             warm_start: bool = False, cfg=None,
                             dstypes=("clean", "final")):
    """Write .flo predictions in the Sintel leaderboard layout (reference
    evaluate.py:21-50 create_sintel_submission). With warm_start, each
    frame's low-res flow is forward-interpolated into the next frame's
    flow_init, reset at scene boundaries. Returns the files written."""
    from vtoonify_tpu_torch.models.raft import RAFTConfig, raft_apply

    cfg = cfg or RAFTConfig()
    dev = _device_of(model)
    written = []
    with torch.inference_mode():
        for dstype in dstypes:
            flow_prev, scene_prev = None, None
            for im1, im2, scene, idx in iter_sintel_test(root, dstype):
                if scene != scene_prev:
                    flow_prev = None
                padder, (x1, x2) = _padded_pair(im1, im2, "sintel", dev)
                flow_init = (None if flow_prev is None else
                             torch.from_numpy(flow_prev).to(dev).permute(2, 0, 1)[None])
                flow_lr, flow_up = raft_apply(model, x1, x2, cfg, iters=iters,
                                              flow_init=flow_init)
                flow = _to_hwc(padder.unpad(flow_up))
                if warm_start:
                    flow_prev = forward_interpolate(_to_hwc(flow_lr))
                out_dir = os.path.join(output_path, dstype, scene)
                os.makedirs(out_dir, exist_ok=True)
                out_file = os.path.join(out_dir, f"frame{idx + 1:04d}.flo")
                write_flo(out_file, flow)
                written.append(out_file)
                scene_prev = scene
    return written


def create_kitti_submission(model, root: str, output_path: str, iters: int = 24,
                            cfg=None):
    """Write KITTI-2015 leaderboard 16-bit flow pngs (reference
    evaluate.py:53-71 create_kitti_submission). Returns the files written."""
    from vtoonify_tpu_torch.models.raft import RAFTConfig, raft_apply

    cfg = cfg or RAFTConfig()
    dev = _device_of(model)
    os.makedirs(output_path, exist_ok=True)
    written = []
    with torch.inference_mode():
        for im1, im2, file_id in iter_kitti_test(root):
            padder, (x1, x2) = _padded_pair(im1, im2, "kitti", dev)
            _, flow_up = raft_apply(model, x1, x2, cfg, iters=iters)
            out_file = os.path.join(output_path, file_id)
            write_kitti_flow(out_file, _to_hwc(padder.unpad(flow_up)))
            written.append(out_file)
    return written
