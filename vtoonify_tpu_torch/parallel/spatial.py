"""One frame split by rows over the devices of an 'sp' mesh (port of the
JAX package's spatial partitioning, vtoonify_tpu/parallel/mesh.py
`shard_spatial`, whose halo exchanges and cross-device reductions GSPMD
derived; here each one is written).

A `RowSharded` activation holds the slabs of one logical tensor, slab i on
the mesh's device i, covering the global rows `spans[i]` of its row axis
(NCHW: dim 2). The model functions take it where they take a tensor:

* row-local ops (elementwise arithmetic, activations, `torch.cat` over
  channels, casts) run slab by slab through `__torch_function__`; any other
  torch function raises, so an op with no sharded form cannot silently
  compute on a slab as if it were the frame;
* windowed ops (convolutions, the FIR resampler, resizes, pools) gather the
  rows each output slab reads from whichever slabs hold them (`rows`: plain
  `.to(device)` copies of a neighbour's edge rows, and of rows further away
  where a window reaches past one slab), run the op with its own padding on
  them and keep the output rows whose window those rows cover: the padding
  counts only at the frame's first and last rows (`map_windows`). On a
  mesh of one slab a conv, a pool, B1 and B3 run exactly as on the whole
  frame;
* global means (BiSeNet's pools, the instance norms) sum over slabs and
  every device receives the same total (`all_reduce_sum`): the result is a
  `Replicated` value, one copy per device, which ops map part by part.

A layer may have fewer rows than the mesh has devices: `partition` gives the
first rows to the first devices and leaves the others empty (zero rows),
and the next layer with more rows splits them again. Parameters live on the
first device; `replicate` registers a copy of a module's parameters and
buffers on each other device, which `local` hands out. Halo, reduction and
gather copies are counted (`stats`).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

_STATS = collections.Counter()
_REPLICAS = WeakIdKeyDictionary()  # tensor -> {device: copy}


def stats() -> dict:
    """Copies between slabs since the last `reset_stats`: halo rows
    (`halo_copies`, `halo_bytes`), the partial sums of the global means
    (`reduce_*`) and the output rows gathered on the first device
    (`gather_*`). A copy between two slabs on one device counts too."""
    return dict(_STATS)


def reset_stats():
    _STATS.clear()


def _count(kind: str, t: torch.Tensor):
    _STATS[f"{kind}_copies"] += 1
    _STATS[f"{kind}_bytes"] += t.numel() * t.element_size()


def partition(height: int, n: int) -> list:
    """The global row spans (start, stop) of n slabs over `height` rows:
    contiguous, in device order, as even as they can be, the first
    height % n one row longer. Fewer rows than slabs leave the last slabs
    empty."""
    k, r = divmod(height, n)
    spans, start = [], 0
    for i in range(n):
        stop = start + k + (i < r)
        spans.append((start, stop))
        start = stop
    return spans


# ---------------------------------------------------------------------------
# parameters on every device


def replicate(module: torch.nn.Module, devices: Sequence) -> list:
    """A copy of `module` on each device of `devices` other than its own
    (each device once); `local` then finds each of its parameters and
    buffers there. Returns the copies (the registry holds them as long as
    the module's tensors live)."""
    tensors = list(module.parameters()) + list(module.buffers())
    if not tensors:
        return []
    home = tensors[0].device
    copies = []
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev == home:
            continue
        rep = copy.deepcopy(module).to(dev)
        for t, r in zip(tensors, list(rep.parameters()) + list(rep.buffers())):
            _REPLICAS.setdefault(t, {})[dev] = r
        copies.append(rep)
    return copies


def local(t, device: torch.device):
    """`t` on `device`: itself where it lies there, else its registered
    replica (`replicate`), else a copy. A CPU scalar goes as it is."""
    if not torch.is_tensor(t) or t.device == device or (
            t.ndim == 0 and t.device.type == "cpu"):
        return t
    rep = _REPLICAS.get(t, {}).get(device)
    if rep is not None:
        return rep
    return t.to(device, non_blocking=True)


def on_device(device: torch.device):
    """The context a slab's work runs in: its card as the current device
    (the kernels launch on the calling thread's current device and
    stream); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _map_parts(fn: Callable, parts) -> list:
    """fn(part) for every part, each on its own device."""
    out = []
    for p in parts:
        with on_device(p.device):
            out.append(fn(p))
    return out


# ---------------------------------------------------------------------------
# the sharded values


def _norm_dim(dim: int, ndim: int) -> int:
    return dim % ndim if ndim else 0


class Sharded:
    """A value held as one part per mesh device (a slab or a replica)."""

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        """The first device's (where derived constants are made)."""
        return self.parts[0].device

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    def map(self, fn: Callable):
        """fn(part) on every part, on its device; the result keeps this
        value's layout."""
        return self._like(_map_parts(fn, self.parts))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _row_local(func, args, kwargs or {})

    # methods the model code calls on activations
    def to(self, *args, **kwargs):
        if any(isinstance(a, (torch.device, str)) for a in args) or "device" in kwargs:
            raise ValueError("a sharded value stays on its mesh: .to() takes a dtype")
        return self.map(lambda t: t.to(*args, **kwargs))

    def float(self):
        return self.map(lambda t: t.float())

    def contiguous(self):
        return self.map(lambda t: t.contiguous())

    def __add__(self, o):
        return _row_local(torch.add, (self, o), {})

    def __radd__(self, o):
        return _row_local(torch.add, (o, self), {})

    def __sub__(self, o):
        return _row_local(torch.sub, (self, o), {})

    def __rsub__(self, o):
        return _row_local(torch.sub, (o, self), {})

    def __mul__(self, o):
        return _row_local(torch.mul, (self, o), {})

    def __rmul__(self, o):
        return _row_local(torch.mul, (o, self), {})

    def __truediv__(self, o):
        return _row_local(torch.div, (self, o), {})

    def __rtruediv__(self, o):
        return _row_local(torch.div, (o, self), {})


class Replicated(Sharded):
    """The same tensor on every mesh device (a global mean and what is
    computed from it); its ops (the row-local ones, `conv2d`) run part by
    part."""

    @property
    def shape(self) -> torch.Size:
        return self.parts[0].shape

    def _like(self, parts):
        return Replicated(parts)


class RowSharded(Sharded):
    """A tensor split along its row axis `axis` over the mesh: part i holds
    the global rows spans[i] = (start, stop) of `height` on its device."""

    def __init__(self, parts, spans, height: int, axis: int = 2):
        super().__init__(parts)
        self.spans = tuple(tuple(s) for s in spans)
        self.height = int(height)
        self.axis = _norm_dim(axis, self.parts[0].ndim)
        if len(self.spans) != len(self.parts):
            raise ValueError("RowSharded: one span per part")
        prev = 0
        for p, (a, b) in zip(self.parts, self.spans):
            if a != prev or p.shape[self.axis] != b - a:
                raise ValueError(f"RowSharded: part of {p.shape[self.axis]} rows at "
                                 f"span {(a, b)} (previous stop {prev})")
            prev = b
        if prev != self.height:
            raise ValueError(f"RowSharded: spans end at {prev}, height {self.height}")

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.axis] = self.height
        return torch.Size(s)

    def _like(self, parts):
        return RowSharded(parts, self.spans, self.height, self.axis)

    def permute(self, *order):
        order = order[0] if len(order) == 1 and not isinstance(order[0], int) else order
        return RowSharded([p.permute(*order) for p in self.parts], self.spans,
                          self.height, list(order).index(self.axis))

    def map_slabs(self, fn: Callable, axis: Optional[int] = None, scale=(1, 1)):
        """fn(slab) on every slab when the rows change: the result's row
        axis is `axis` and its row r holds the input rows r * den / num, for
        scale = (num, den); every span must map to whole rows."""
        num, den = scale
        spans = [(a * num // den, b * num // den) for a, b in self.spans]
        if any(a * num % den or b * num % den for a, b in self.spans):
            raise ValueError(f"map_slabs: spans {self.spans} do not scale by {scale}")
        return RowSharded(_map_parts(fn, self.parts), spans,
                          self.height * num // den, self.axis if axis is None else axis)


# functions computed slab by slab: each output element reads only the
# inputs' elements at its own position (after broadcasting)
_ROW_LOCAL = {
    torch.add, torch.sub, torch.mul, torch.div, torch.neg, torch.abs,
    torch.Tensor.add, torch.Tensor.sub, torch.Tensor.mul, torch.Tensor.div,
    torch.Tensor.__rsub__, torch.Tensor.__rtruediv__, torch.Tensor.neg,
    torch.relu, F.relu, F.leaky_relu, torch.sigmoid, torch.tanh, torch.rsqrt,
    torch.sqrt, torch.square, torch.clamp, torch.round, torch.where, torch.cat,
}


def _flatten(args, kwargs):
    """The operands of a row-local call, flat: the arguments, a list or
    tuple argument (torch.cat's) opened one level, then the keyword values."""
    leaves, shape = [], []
    for a in args:
        seq = isinstance(a, (list, tuple))
        shape.append(len(a) if seq else None)
        leaves.extend(a if seq else (a,))
    leaves.extend(kwargs.values())
    return leaves, (shape, list(kwargs))


def _unflatten(leaves, spec):
    shape, keys = spec
    args, i = [], 0
    for n in shape:
        args.append(leaves[i] if n is None else list(leaves[i:i + n]))
        i += 1 if n is None else n
    return args, dict(zip(keys, leaves[i:]))


def _row_local(func, args, kwargs):
    if func not in _ROW_LOCAL:
        raise TypeError(f"{getattr(func, '__name__', func)} has no row-sharded form "
                        "(vtoonify_tpu_torch.parallel.spatial)")
    leaves, spec = _flatten(args, kwargs)
    shards = [a for a in leaves if isinstance(a, Sharded)]
    n = len(shards[0].parts)
    if any(len(s.parts) != n for s in shards):
        raise ValueError("sharded operands over meshes of different sizes")
    rows = [s for s in shards if isinstance(s, RowSharded)]
    ref = rows[0] if rows else None
    if ref is not None:
        if any(r.height != ref.height or r.axis != ref.axis for r in rows):
            raise ValueError("row-sharded operands of different heights or row axes")
        if func is torch.cat:
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            if _norm_dim(dim, ref.ndim) == ref.axis:
                raise ValueError("torch.cat along the sharded row axis")
        leaves = [repartition(a, ref.spans) if isinstance(a, RowSharded) else a
                  for a in leaves]
        for a in leaves:  # a whole-height operand cannot meet a slab
            for t in (a.parts[:1] if isinstance(a, Replicated) else
                      [a] if torch.is_tensor(a) else []):
                d = ref.axis - (ref.ndim - t.ndim)
                if d >= 0 and t.shape[d] != 1:
                    raise ValueError(f"an operand of shape {tuple(t.shape)} broadcast "
                                     "against row slabs")
    parts = []
    for i in range(n):
        dev = shards[0].parts[i].device
        li = [a.parts[i] if isinstance(a, Sharded) else local(a, dev) for a in leaves]
        a_i, k_i = _unflatten(li, spec)
        parts.append(func(*a_i, **k_i))
    if ref is None:
        return Replicated(parts)
    return RowSharded(parts, ref.spans, ref.height, ref.axis)


# ---------------------------------------------------------------------------
# moving rows


def shard_rows(x, devices: Sequence, dim: int = 2) -> RowSharded:
    """A host array or tensor split along `dim` by `partition`, slab i
    copied to devices[i]."""
    x = torch.as_tensor(x)
    dim = _norm_dim(dim, x.ndim)
    spans = partition(x.shape[dim], len(devices))
    parts = [x.narrow(dim, a, b - a).to(torch.device(d)) for (a, b), d in zip(spans, devices)]
    return RowSharded(parts, spans, x.shape[dim], dim)


def rows(x: RowSharded, a: int, b: int, i: int) -> torch.Tensor:
    """The global rows [a, b) of x (0 <= a, b <= height) on slab i's
    device: slab i's own rows and the rows of other slabs copied over (the
    halo)."""
    dev, d = x.parts[i].device, x.axis
    if b <= a:
        return x.parts[i].narrow(d, 0, 0)
    pieces = []
    for j, ((s, e), p) in enumerate(zip(x.spans, x.parts)):
        lo, hi = max(a, s), min(b, e)
        if lo >= hi:
            continue
        piece = p.narrow(d, lo - s, hi - lo)
        if j != i:
            piece = piece.to(dev, non_blocking=True)
            _count("halo", piece)
        pieces.append(piece)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, d)


def repartition(x: RowSharded, spans) -> RowSharded:
    """x split at other row boundaries (each slab gathers its new rows)."""
    spans = tuple(tuple(s) for s in spans)
    if spans == x.spans:
        return x
    return RowSharded([rows(x, a, b, i) for i, (a, b) in enumerate(spans)], spans,
                      x.height, x.axis)


def aligned(x: RowSharded, m: int) -> RowSharded:
    """x split at multiples of m rows (a height m divides)."""
    if x.height % m:
        raise ValueError(f"aligned: height {x.height} is not a multiple of {m}")
    return repartition(x, [(a * m, b * m) for a, b in partition(x.height // m, len(x.parts))])


def map_windows(x: RowSharded, fn: Callable, out_height: int,
                window: Callable, out_spans=None) -> RowSharded:
    """A windowed op on row slabs. Output slab i covers out_spans[i]
    (default: `partition(out_height)`); for its rows [o0, o1) the op reads
    the input's global rows window(o0, o1) = (a, b), which `rows` gathers
    onto slab i's device, cut to the frame's rows; fn(rows, o0, o1, a), a
    the first row gathered, returns exactly its o1 - o0 output rows (beyond
    the frame's edges the op pads as it does on the whole frame). An empty
    output slab runs nothing."""
    n = len(x.parts)
    out_spans = partition(out_height, n) if out_spans is None else out_spans
    parts = [None] * n
    for i, (o0, o1) in enumerate(out_spans):
        if o1 > o0:
            a, b = window(o0, o1)
            a, b = max(a, 0), min(b, x.height)
            with on_device(x.parts[i].device):
                parts[i] = fn(rows(x, a, b, i), o0, o1, a)
    full = next(p for p in parts if p is not None)
    for i, p in enumerate(parts):
        if p is None:
            shape = list(full.shape)
            shape[x.axis] = 0
            parts[i] = full.new_empty(shape, device=x.parts[i].device)
    return RowSharded(parts, out_spans, out_height, x.axis)


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> Replicated:
    """The sum of one partial tensor per device, on every device: each adds
    all partials in device order, so every copy holds the same numbers."""
    out = []
    for i, own in enumerate(parts):
        total = None
        for j, p in enumerate(parts):
            if j != i:
                p = p.to(own.device, non_blocking=True)
                _count("reduce", p)
            total = p if total is None else total + p
        out.append(total)
    return Replicated(out)


def gather(x: RowSharded, device=None) -> torch.Tensor:
    """The whole tensor on `device` (default: the first slab's): the slabs
    concatenated along the row axis."""
    device = x.parts[0].device if device is None else torch.device(device)
    parts = []
    for j, p in enumerate(x.parts):
        if j:
            _count("gather", p)
        parts.append(p.to(device, non_blocking=True))
    return torch.cat(parts, x.axis)


# ---------------------------------------------------------------------------
# convolution


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _even(a: int, m: int = 1) -> int:
    """The nearest row at or above a that is even and a multiple of m. A
    slab's rows are gathered from an even row, so that a row keeps the
    parity it has in the frame: the bf16 tensor-core kernel (B1) works on
    rows in pairs, and its rounding follows a row's parity."""
    m = m * 2 // math.gcd(m, 2)
    return a - a % m


def strided_window(fn: Callable, x: RowSharded, k: int, stride: int, pad: int,
                   dilation: int = 1) -> RowSharded:
    """An op with a window of k rows (dilated), a row stride and a padding
    of `pad` rows at each end (a conv, a pool) on row slabs: each slab runs
    fn(rows) (the op with its own padding) on rows gathered from a multiple
    of the stride, so its output rows fall on the frame's, and keeps the
    rows its span asks for; the ones beside an interior slab edge, which
    read the op's padding there, are dropped."""
    keff = dilation * (k - 1) + 1
    out_h = (x.height + 2 * pad - keff) // stride + 1
    spans = x.spans if stride == 1 and out_h == x.height else None
    lead = -(-pad // stride)  # output rows before the first whose window starts in the rows

    return map_windows(
        x, lambda t, o0, o1, a: fn(t).narrow(x.axis, o0 - a // stride, o1 - o0), out_h,
        lambda o0, o1: (_even(stride * (o0 - lead), stride),
                        (o1 - 1) * stride - pad + keff), spans)


def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """F.conv2d on row slabs (`strided_window`) or on a replicated value
    (part by part)."""
    if isinstance(x, Replicated):
        return x.map(lambda t: F.conv2d(t, local(w, t.device), local(bias, t.device),
                                        stride, padding, dilation, groups))
    (sh, _), (ph, _), (dh, _) = _pair(stride), _pair(padding), _pair(dilation)
    return strided_window(
        lambda t: F.conv2d(t, local(w, t.device), local(bias, t.device), stride, padding,
                           dilation, groups), x, w.shape[2], sh, ph, dh)


def same_conv3x3(x: RowSharded, conv: Callable, upsample: bool = False) -> RowSharded:
    """A stride-1 3x3 conv with its own zero padding of one row (kernel B1,
    which pads H itself) on row slabs: each slab runs conv on its rows with
    a halo row on each side where it has a neighbour there (two above where
    its first row is even: `_even`), and the output rows those halo rows
    give are dropped. With `upsample`, conv is the
    polyphase x2 up conv with its interleave (B1 then B4): one row in gives
    two out, and output slab i holds the rows of twice its input span."""
    f = 2 if upsample else 1
    return map_windows(
        x, lambda t, o0, o1, a: conv(t.contiguous()).narrow(x.axis, o0 - f * a, o1 - o0),
        f * x.height, lambda o0, o1: (_even(o0 // f - 1), o1 // f + 1),
        [(a * f, b * f) for a, b in x.spans])
