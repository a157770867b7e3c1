"""RAFT optical flow, basic variant (port of vtoonify_tpu/models/raft.py:
`RAFTConfig`, the basic encoders, `build_corr_pyramid` / `lookup_corr`,
`build_fmap_pyramid` / `lookup_corr_alt`, the SepConvGRU update block,
`upsample_flow_convex`, `init_raft`, `raft_apply`).

Used by the parsing-map smoother (pipeline/smooth_parsing.py). Activations
are NCHW; images are (B, 3, H, W) in [0, 255] and flows (B, 2, h, w) with
channel 0 the x and channel 1 the y displacement. The modules carry the JAX
package's parameter tree names (`fnet` / `cnet` / `update.{enc, gru,
flow_head, mask}`), so `convert/from_jax.py::load_jax_params` fills them
from JAX's `init_raft` params or `convert_raft` of a reference checkpoint.

Two correlation implementations with the same outputs: "allpairs" (the
reference CorrBlock: one batched matmul for the (h·w)² volume, then an
avg-pool pyramid and bilinear lookups) and "alt" (the reference's
alt_cuda_corr: each lookup window is correlated on the fly against a
feature pyramid of image 2, exact by linearity, O(h·w·C) memory; the only
path that fits HD inputs). Neither was a Pallas kernel in the JAX package.
Batch norm runs in eval mode, except in training with `train_bn=True`
(models/raft_train.py), where the context encoder normalizes with batch
statistics and updates its running buffers in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops.interp import avg_pool, grid_sample


@dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    corr_impl: str = "allpairs"  # or "alt": on-the-fly lookup, same outputs


# --- encoders (extractor.py BasicEncoder) -------------------------------------


class _Norms(nn.Module):
    """A residual block's batch norms (the cnet's; the fnet's instance norms
    hold no parameters)."""

    def __init__(self, ch, with_norm3):
        super().__init__()
        self.norm1 = L.BatchNorm2d(ch)
        self.norm2 = L.BatchNorm2d(ch)
        if with_norm3:
            self.norm3 = L.BatchNorm2d(ch)


class ResBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride, batch_norm, generator=None):
        super().__init__()
        g = generator
        self.conv1 = L.Conv2dTorch(in_ch, out_ch, 3, generator=g)
        self.conv2 = L.Conv2dTorch(out_ch, out_ch, 3, generator=g)
        if stride != 1:
            self.down = L.Conv2dTorch(in_ch, out_ch, 1, generator=g)
        if batch_norm:
            self.norms = _Norms(out_ch, stride != 1)


def _norm(x, norm_fn, bn, train_bn=False):
    if norm_fn == "instance":
        return L.instance_norm_2d(x)
    if train_bn:
        return L.batch_norm_2d_train(bn, x)
    return L.batch_norm_2d(bn, x)


def res_block(p: ResBlock, x, stride, norm_fn, train_bn=False):
    norms = getattr(p, "norms", None)

    def nrm(h, name):
        return _norm(h, norm_fn, None if norms is None else getattr(norms, name),
                     train_bn)

    y = F.relu(nrm(L.conv2d_torch(p.conv1, x, stride=stride, padding=1), "norm1"))
    y = F.relu(nrm(L.conv2d_torch(p.conv2, y, padding=1), "norm2"))
    if hasattr(p, "down"):
        x = nrm(L.conv2d_torch(p.down, x, stride=stride), "norm3")
    return F.relu(x + y)


_ENCODER_DIMS = ((64, 64, 1), (64, 96, 2), (96, 128, 2))


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm_fn, generator=None):
        super().__init__()
        g = generator
        bn = norm_fn == "batch"
        self.conv1 = L.Conv2dTorch(3, 64, 7, generator=g)
        self.layers = nn.ModuleList([
            nn.ModuleList([ResBlock(cin, cout, stride, bn, g),
                           ResBlock(cout, cout, 1, bn, g)])
            for cin, cout, stride in _ENCODER_DIMS])
        self.conv2 = L.Conv2dTorch(128, output_dim, 1, generator=g)
        if bn:
            self.bn1 = L.BatchNorm2d(64)


def basic_encoder_apply(p: BasicEncoder, x, norm_fn, train_bn=False):
    """(B, 3, H, W) in [-1, 1] -> (B, output_dim, H/8, W/8). train_bn (batch
    norm_fn only): batch statistics, and `p`'s running buffers updated in
    place."""
    train_bn = train_bn and norm_fn == "batch"
    h = L.conv2d_torch(p.conv1, x, stride=2, padding=3)
    h = F.relu(_norm(h, norm_fn, getattr(p, "bn1", None), train_bn))
    for layer, (_, _, stride) in zip(p.layers, _ENCODER_DIMS):
        h = res_block(layer[0], h, stride, norm_fn, train_bn)
        h = res_block(layer[1], h, 1, norm_fn, train_bn)
    return L.conv2d_torch(p.conv2, h)


# --- correlation (corr.py CorrBlock, alt_cuda_corr) ---------------------------


def _pool2(x):
    """2x2 average pool of a pyramid level. A level under 2 px on a side
    pools to an empty one (inputs under 64 px), as the JAX package's
    reduce_window gives; `_sample` reads zeros there."""
    if min(x.shape[2:]) < 2:
        return x.new_zeros((*x.shape[:2], x.shape[2] // 2, x.shape[3] // 2))
    return avg_pool(x, 2)


def _sample(x, grid):
    """Bilinear lookup with zero padding (align_corners=True); an empty
    level reads zeros everywhere."""
    if x.shape[2] == 0 or x.shape[3] == 0:
        return x.new_zeros((*x.shape[:2], *grid.shape[1:3]))
    return grid_sample(x, grid, align_corners=True, padding_mode="zeros")


def build_corr_pyramid(fmap1, fmap2, num_levels=4):
    """All-pairs correlation of (B, C, h, w) feature maps: one batched
    matmul into (B·h·w, 1, h, w), then an avg-pool pyramid over the image-2
    axes. The pyramid is float32 under bfloat16 autocast too (the JAX
    package's einsum accumulates to float32): the lookups' grid_sample would
    otherwise cast every level to float32 again on each iteration, and
    autograd keep each copy."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w).float()
    f2 = fmap2.reshape(b, c, h * w).float()
    # scaled in place: the (h·w)² volume is the smoother's largest buffer
    corr = torch.matmul(f1.transpose(1, 2), f2).float().div_(math.sqrt(c))
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = _pool2(corr)
        pyramid.append(corr)
    return pyramid


def _window_delta(radius, device):
    """((2r+1)², 2) lookup-window offsets as (x, y), row-major over the
    window. The reference adds stack(meshgrid(dy, dx)) to (x, y)-ordered
    coords (corr.py:36-41): the x offset varies along the FIRST window axis.
    The channel order of the lookup (which convc1's weights see) follows."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    first, second = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([first, second], dim=-1).reshape(-1, 2)


def _norm_grid(coords, hl, wl):
    """Pixel (x, y) coords (..., 2) -> grid_sample's [-1, 1] with
    align_corners=True. A 1-pixel axis maps to coordinate 0 (the reference
    divides by zero there)."""
    gx = (2 * coords[..., 0] / (wl - 1) - 1) if wl > 1 else torch.zeros_like(coords[..., 0])
    gy = (2 * coords[..., 1] / (hl - 1) - 1) if hl > 1 else torch.zeros_like(coords[..., 1])
    return torch.stack([gx, gy], dim=-1)


def lookup_corr(pyramid, coords, radius=4):
    """coords (B, 2, h, w): pixel positions in image 2. Returns
    (B, levels·(2r+1)², h, w), per level the window row-major (reference
    corr.py:29-50)."""
    b, _, h, w = coords.shape
    n = 2 * radius + 1
    delta = _window_delta(radius, coords.device).reshape(1, n, n, 2)
    centroid = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        grid = _norm_grid(centroid / (2 ** i) + delta, hl, wl)
        sampled = _sample(corr, grid)
        out.append(sampled.reshape(b, h, w, n * n))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def build_fmap_pyramid(fmap, num_levels=4):
    """Avg-pool pyramid of the (B, C, h, w) image-2 features: the alt
    lookup's state, O(h·w·C) where the all-pairs volume is O((h·w)²)."""
    pyr = [fmap.float()]
    for _ in range(num_levels - 1):
        pyr.append(_pool2(pyr[-1]))
    return pyr


def lookup_corr_alt(fmap1, fmap2_pyramid, coords, radius=4, offset_chunk=9):
    """The lookup of `lookup_corr(build_corr_pyramid(f1, f2), coords)`
    without the volume. corr(n, m) = f1ₙ·f2ₘ/√C is linear in f2ₘ, so
    pooling the volume equals correlating against the pooled f2, and
    sampling it bilinearly equals correlating against the sampled f2. Per
    level the window offsets go in chunks: one grid_sample of the level's
    features at coords/2ⁱ + the chunk's offsets, then a batched dot with f1;
    the transient is (B, C, h·w, chunk).

    fmap1 (B, C, h, w); fmap2_pyramid from `build_fmap_pyramid`; coords
    (B, 2, h, w). Returns (B, levels·(2r+1)², h, w) in `lookup_corr`'s
    channel order."""
    b, c, h, w = fmap1.shape
    n_off = (2 * radius + 1) ** 2
    delta = _window_delta(radius, coords.device)
    offset_chunk = max(1, min(offset_chunk, n_off))
    while n_off % offset_chunk:
        offset_chunk -= 1
    # (B·h·w, 1, C): the batched dot's left operand
    f1 = fmap1.float().reshape(b, c, h * w).transpose(1, 2).reshape(b * h * w, 1, c)
    centroid = coords.permute(0, 2, 3, 1).reshape(b, h * w, 1, 2)
    out = []
    for i, f2l in enumerate(fmap2_pyramid):
        hl, wl = f2l.shape[2:]
        lvl = []
        for s in range(0, n_off, offset_chunk):
            dk = delta[s:s + offset_chunk]
            grid = _norm_grid(centroid / (2 ** i) + dk, hl, wl)  # (B, h·w, k, 2)
            smp = _sample(f2l, grid)
            smp = smp.permute(0, 2, 1, 3).reshape(b * h * w, c, dk.shape[0])
            lvl.append(torch.bmm(f1, smp).reshape(b, h * w, dk.shape[0]))
        out.append(torch.cat(lvl, dim=-1) * (1.0 / math.sqrt(c)))
    return torch.cat(out, dim=-1).transpose(1, 2).reshape(b, -1, h, w)


# --- update block (update.py) ---------------------------------------------------


class RectConv(nn.Module):
    """A (kh, kw) conv with nn.Conv2d's default init (the GRU's (1, 5) and
    (5, 1) convs)."""

    def __init__(self, in_ch, out_ch, khw, generator=None):
        super().__init__()
        kh, kw = khw
        fan_in = in_ch * kh * kw
        self.weight = L._param(L._uniform(generator, (out_ch, in_ch, kh, kw),
                                          math.sqrt(6.0 / ((1 + 5.0) * fan_in))))
        self.bias = L._param(L._uniform(generator, (out_ch,), 1.0 / math.sqrt(fan_in)))


def _sep_conv(p: RectConv, x):
    """Same-padded (1, 5) / (5, 1) conv."""
    kh, kw = p.weight.shape[2:]
    return L.conv2d_torch(p, x, padding=((kh - 1) // 2, (kw - 1) // 2))


_GRU = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")


def sep_conv_gru(p, h, x):
    """SepConvGRU (update.py:33-60): a horizontal then a vertical pass."""
    for z_c, r_c, q_c in ((p.convz1, p.convr1, p.convq1),
                          (p.convz2, p.convr2, p.convq2)):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_sep_conv(z_c, hx))
        r = torch.sigmoid(_sep_conv(r_c, hx))
        q = torch.tanh(_sep_conv(q_c, torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
    return h


def _holder(**modules):
    m = nn.Module()
    for k, v in modules.items():
        setattr(m, k, v)
    return m


class UpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig, generator=None):
        super().__init__()
        g = generator
        cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        hd = cfg.hidden_dim
        C = L.Conv2dTorch
        self.enc = _holder(convc1=C(cor_planes, 256, 1, generator=g),
                           convc2=C(256, 192, 3, generator=g),
                           convf1=C(2, 128, 7, generator=g),
                           convf2=C(128, 64, 3, generator=g),
                           conv=C(64 + 192, 128 - 2, 3, generator=g))
        self.gru = _holder(**{
            name: RectConv(hd + 128 + hd, hd, (1, 5) if name.endswith("1") else (5, 1), g)
            for name in _GRU})
        self.flow_head = _holder(conv1=C(hd, 256, 3, generator=g),
                                 conv2=C(256, 2, 3, generator=g))
        self.mask = _holder(conv1=C(128, 256, 3, generator=g),
                            conv2=C(256, 64 * 9, 1, generator=g))


def update_block_apply(p: UpdateBlock, net, inp, corr, flow):
    """-> (net, up-sampling mask (B, 576, h, w), flow delta (B, 2, h, w))."""
    e = p.enc
    cor = F.relu(L.conv2d_torch(e.convc1, corr))
    cor = F.relu(L.conv2d_torch(e.convc2, cor, padding=1))
    flo = F.relu(L.conv2d_torch(e.convf1, flow, padding=3))
    flo = F.relu(L.conv2d_torch(e.convf2, flo, padding=1))
    out = F.relu(L.conv2d_torch(e.conv, torch.cat([cor, flo], dim=1), padding=1))
    motion = torch.cat([out, flow], dim=1)
    net = sep_conv_gru(p.gru, net, torch.cat([inp, motion], dim=1))
    fh, m = p.flow_head, p.mask
    delta = L.conv2d_torch(fh.conv2, F.relu(L.conv2d_torch(fh.conv1, net, padding=1)),
                           padding=1)
    mask = 0.25 * L.conv2d_torch(m.conv2, F.relu(L.conv2d_torch(m.conv1, net, padding=1)))
    return net, mask, delta


# --- the model ------------------------------------------------------------------


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig(), generator=None):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance", generator)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch", generator)
        self.update = UpdateBlock(cfg, generator)


def init_raft(cfg: RAFTConfig = RAFTConfig(), generator=None) -> RAFT:
    return RAFT(cfg, generator)


def _coords_grid(b, h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys])[None].expand(b, 2, h, w)


def upsample_flow_convex(flow, mask):
    """Convex-combination 8x upsampling (raft.py:72-83): flow (B, 2, h, w),
    mask (B, 9·8·8, h, w) with channel k·64 + 8y + x for neighbour k of the
    3x3 window (row-major) and sub-pixel (y, x) -> (B, 2, 8h, 8w)."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 9, 8, 8, h, w), dim=1)
    fp = F.pad(8 * flow, (1, 1, 1, 1))  # zero padding, F.unfold's
    neigh = torch.stack([fp[:, :, dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], dim=2)  # (B, 2, 9, h, w)
    up = torch.einsum("bkyxhw,bckhw->bchywx", mask, neigh)
    return up.reshape(b, 2, 8 * h, 8 * w)


def raft_apply(model: RAFT, image1, image2, cfg: RAFTConfig = RAFTConfig(),
               iters: int = 12, test_mode: bool = True, train_bn: bool = False,
               flow_init=None):
    """image1 / image2: (B, 3, H, W) in [0, 255], H and W multiples of 8.
    Returns (flow at 1/8, flow upsampled) in test mode, else the list of
    each iteration's upsampled flow. train_bn (with test_mode=False, the
    'chairs' stage of training): the context encoder's batch norm uses batch
    statistics and updates its running buffers in place. The refinement
    loop does not stop the gradient through coords1, as the JAX package
    does (upstream RAFT detaches it each iteration). flow_init: an optional
    (B, 2, H/8, W/8) warm start (reference raft.py:124-125)."""
    if cfg.corr_impl not in ("allpairs", "alt"):
        raise ValueError(f"corr_impl {cfg.corr_impl!r}: 'allpairs' or 'alt'")
    alt = cfg.corr_impl == "alt"
    x1 = 2 * (image1 / 255.0) - 1.0
    x2 = 2 * (image2 / 255.0) - 1.0
    # one fnet call over both images (instance norm is per sample)
    fmap1, fmap2 = basic_encoder_apply(
        model.fnet, torch.cat([x1, x2], dim=0), "instance").chunk(2, dim=0)
    pyramid = (build_fmap_pyramid(fmap2, cfg.corr_levels) if alt
               else build_corr_pyramid(fmap1, fmap2, cfg.corr_levels))

    cnet = basic_encoder_apply(model.cnet, x1, "batch",
                               train_bn=train_bn and not test_mode)
    net = torch.tanh(cnet[:, :cfg.hidden_dim])
    inp = F.relu(cnet[:, cfg.hidden_dim:])

    b, _, h, w = fmap1.shape
    coords0 = _coords_grid(b, h, w, x1.device)
    coords1 = coords0 if flow_init is None else coords0 + flow_init

    flows_up = []
    for it in range(iters):
        corr = (lookup_corr_alt(fmap1, pyramid, coords1, cfg.corr_radius) if alt
                else lookup_corr(pyramid, coords1, cfg.corr_radius))
        net, up_mask, delta = update_block_apply(model.update, net, inp, corr,
                                                 coords1 - coords0)
        coords1 = coords1 + delta
        if not test_mode or it == iters - 1:  # test mode reads the last only
            flows_up.append(upsample_flow_convex(coords1 - coords0, up_mask))

    if test_mode:
        return coords1 - coords0, flows_up[-1]
    return flows_up
