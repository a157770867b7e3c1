"""Tensor parallelism over a 'tp' row of devices, in one process (the port
of what GSPMD inserts for the JAX package's channel split,
vtoonify_tpu/parallel/mesh.py `param_partition_spec` and
`shard_params(tp=True)`).

A wide parameter (`partition_dim`: the axis JAX's rule splits, in the
port's layout) is held as `Shards`: one `nn.Parameter` per device of the
row, each a contiguous slab of the whole along that axis (a conv's or a
linear's output channels, dim 0 of OIHW and (out, in); an image-like
constant's channels, dim 1 of NCHW). The `Shards` module takes the
parameter's place (`p.weight` is then the Shards), so `named_parameters`,
`functional_call`, Adam, the EMA and the gradient all-reduce see each shard
as a parameter of its own. Its owner's state-dict hooks keep `state_dict()`
whole, under the parameter's own name, and split a whole tensor again in
`load_state_dict`: a checkpoint is the same at any tp.
`optimizer_state_dict` / `load_optimizer_state_dict` do the same for an
optimizer's per-parameter state.

Activations stay on the row's first device. A wide layer (`split_out`)
copies its input to each shard's device, runs the layer's own function there
with its weight shard (the kernels under `on_device`, as a row slab's in
`parallel.spatial`) and concatenates the output-channel slabs on the first
device: the all-gather. Each output channel is then the same reduction as
in the whole layer. Narrow layers, norms and elementwise work run once, on
the first device. Autograd carries the backward through the copies and the
concatenation; nothing crosses processes. `stats()` counts the copies.
"""

from __future__ import annotations

import collections
from typing import Callable, Sequence

import torch
from torch import nn

from vtoonify_tpu_torch.parallel.spatial import Sharded, on_device

_STATS = collections.Counter()


def stats() -> dict:
    """Copies since the last `reset_stats`: each layer input and shared
    operand sent to a shard after the first (`broadcast_copies`,
    `broadcast_bytes`) and each such shard's output slab gathered on the
    first device (`gather_*`). A copy to a shard on the first device counts
    too (one card carrying a 'tp' axis): the counts are what a row of
    distinct cards would move."""
    return dict(_STATS)


def reset_stats():
    _STATS.clear()


def _count(kind: str, t: torch.Tensor):
    _STATS[f"{kind}_copies"] += 1
    _STATS[f"{kind}_bytes"] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the rule and the shards


def partition_dim(name: str, t: torch.Tensor, min_channels: int = 256):
    """The axis of parameter `name` that tensor parallelism splits, or None:
    the axis `convert.from_jax` maps the JAX leaf's last axis to, where the
    JAX rule splits a 4-D or 2-D leaf whose last axis has at least
    `min_channels`. A 4-D or 2-D `weight` (a conv's OIHW, a linear's
    (out, in)): dim 0; any other 4-D leaf (image-like, NCHW): dim 1; any
    other 2-D leaf: dim 1."""
    if t.ndim not in (2, 4):
        return None
    d = 0 if name == "weight" else 1
    return d if t.shape[d] >= min_channels else None


class Shards(nn.ParameterList):
    """The shards of one wide parameter along `dim`, shard j on the j-th
    device of a 'tp' row. Stands where the parameter stood."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int):
        super().__init__(parts)
        self.dim = dim

    @property
    def spans(self) -> list:
        """Each shard's (start, stop) along `dim` of the whole."""
        out, a = [], 0
        for p in self:
            out.append((a, a + p.shape[self.dim]))
            a += p.shape[self.dim]
        return out

    @property
    def shape(self) -> torch.Size:
        s = list(self[0].shape)
        s[self.dim] = self.spans[-1][1]
        return torch.Size(s)

    @property
    def dtype(self):
        return self[0].dtype

    @property
    def device(self):
        return self[0].device

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first shard's),
        differentiably."""
        home = self[0].device if device is None else torch.device(device)
        return torch.cat([p.to(home) for p in self], self.dim)


def whole(t, device=None):
    """`t` itself, or the whole of `Shards` on `device`."""
    return t.full(device) if isinstance(t, Shards) else t


def _merge_shards(module, state_dict, prefix, local_metadata):
    """State-dict post-hook of a module that owns Shards: each shard key
    `NAME.j` folded into the whole tensor under `NAME`."""
    for name, child in module._modules.items():
        if isinstance(child, Shards):
            keys = [f"{prefix}{name}.{j}" for j in range(len(child))]
            if all(k in state_dict for k in keys):
                parts = [state_dict.pop(k) for k in keys]
                state_dict[prefix + name] = torch.cat(
                    [p.to(parts[0].device) for p in parts], child.dim)


def _split_shards(module, state_dict, prefix, local_metadata, strict,
                  missing_keys, unexpected_keys, error_msgs):
    """Load-state-dict pre-hook of a module that owns Shards: a whole
    tensor under `NAME` split into the shard keys `NAME.j` (a tensor of
    another shape is left for load_state_dict to report)."""
    for name, child in module._modules.items():
        key = prefix + name
        if isinstance(child, Shards) and key in state_dict:
            full = state_dict[key]
            if tuple(full.shape) != tuple(child.shape):
                continue
            del state_dict[key]
            for j, (a, b) in enumerate(child.spans):
                state_dict[f"{key}.{j}"] = full.narrow(child.dim, a, b - a)


def is_sharded(module: nn.Module) -> bool:
    return any(isinstance(m, Shards) for m in module.modules())


def shard_module(module: nn.Module, devices: Sequence, min_channels: int = 256):
    """Split `module`'s wide parameters over `devices` (a 'tp' row; a device
    may repeat), in place: every tensor first moves to the row's first
    device, then each parameter `partition_dim` splits becomes `Shards` of
    equal slabs, slab j on devices[j]. A width the row does not divide is
    refused. Returns the module."""
    devices = [torch.device(d) for d in devices]
    if is_sharded(module):
        raise ValueError("shard_module: the module is already sharded")
    module.to(devices[0])
    k = len(devices)
    if k == 1:
        return module
    for owner in list(module.modules()):
        hooked = False
        for name, p in list(owner._parameters.items()):
            dim = None if p is None else partition_dim(name, p, min_channels)
            if dim is None:
                continue
            n = p.shape[dim]
            if n % k:
                raise ValueError(f"tp={k} does not divide the {n} channels of "
                                 f"a {tuple(p.shape)} parameter '{name}' "
                                 f"({type(owner).__name__})")
            m = n // k
            parts = [nn.Parameter(p.detach().narrow(dim, j * m, m).to(d)
                                  .clone(memory_format=torch.contiguous_format),
                                  requires_grad=p.requires_grad)
                     for j, d in enumerate(devices)]
            del owner._parameters[name]
            owner.add_module(name, Shards(parts, dim))  # where the parameter stood
            hooked = True
        if hooked:
            owner.register_state_dict_post_hook(_merge_shards)
            owner.register_load_state_dict_pre_hook(_split_shards)
    return module


# ---------------------------------------------------------------------------
# the column-split layer


def split_out(fn: Callable, w, x, per_channel: Sequence = (), shared: Sequence = (),
              dim: int = 1):
    """fn(w, x, *per_channel, *shared) for a whole weight `w`; for `Shards`
    (split along dim 0: output channels) the same function on each shard's
    device with its shard, the slabs of the per-channel operands (1-D, one
    entry per output channel, or None) and copies of x and of the shared
    operands, the outputs concatenated along `dim` on x's device."""
    if not isinstance(w, Shards):
        return fn(w, x, *per_channel, *shared)
    if isinstance(x, Sharded):
        raise TypeError("tensor parallelism takes whole activations, not row slabs")
    if w.dim != 0:
        raise ValueError("split_out: the weight must be split along its output channels")
    home = x.device
    outs = []
    for j, (part, (a, b)) in enumerate(zip(w, w.spans)):
        dev = part.device

        def send(t, j=j, dev=dev):
            if t is None or not torch.is_tensor(t):
                return t
            if j:
                _count("broadcast", t)
            return t.to(dev)

        ops = [None if v is None else send(v[a:b]) for v in per_channel]
        with on_device(dev):
            outs.append(fn(part, send(x), *ops, *(send(v) for v in shared)))
    for o in outs[1:]:
        _count("gather", o)
    return torch.cat([o.to(home) for o in outs], dim)


# ---------------------------------------------------------------------------
# optimizer state at any tp


def logical_parameters(module: nn.Module) -> list:
    """(name, parameter or Shards) of the module as it would be unsharded:
    a Shards once, under its parameter's name (named_parameters order: a
    split parameter comes after its owner's other parameters)."""
    shards = {n: m for n, m in module.named_modules() if isinstance(m, Shards)}
    out, seen = [], set()
    for name, p in module.named_parameters():
        owner = name.rpartition(".")[0]
        if owner in shards:
            if owner not in seen:
                seen.add(owner)
                out.append((owner, shards[owner]))
        else:
            out.append((name, p))
    return out


def _param_index(opt, module) -> dict:
    params = list(module.parameters())
    in_opt = [p for g in opt.param_groups for p in g["params"]]
    if len(opt.param_groups) != 1 or len(in_opt) != len(params) or any(
            a is not b for a, b in zip(in_opt, params)):
        raise ValueError("the optimizer does not hold the module's parameters, "
                         "in order, in one group")
    return {id(p): i for i, p in enumerate(params)}


def optimizer_state_dict(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """`opt.state_dict()` for an optimizer over `module.parameters()`,
    keyed by the unsharded parameter names, each sharded per-parameter
    tensor whole: the same at any tp."""
    sd = opt.state_dict()
    index = _param_index(opt, module)
    state = {}
    for name, t in logical_parameters(module):
        if isinstance(t, Shards):
            parts = [sd["state"].get(index[id(p)]) for p in t]
            if any(s is None for s in parts):
                continue
            state[name] = {
                k: (torch.cat([s[k].to(v.device) for s in parts], t.dim)
                    if torch.is_tensor(v) and v.ndim else v)
                for k, v in parts[0].items()}
        elif index[id(t)] in sd["state"]:
            state[name] = sd["state"][index[id(t)]]
    return {"state": state,
            "param_groups": [{k: v for k, v in g.items() if k != "params"}
                             for g in sd["param_groups"]],
            "names": [n for n, _ in logical_parameters(module)]}


def load_optimizer_state_dict(opt: torch.optim.Optimizer, module: nn.Module,
                              saved: dict) -> None:
    """Load an `optimizer_state_dict` into `opt` over `module.parameters()`,
    splitting each whole per-parameter tensor over the module's shards."""
    index = _param_index(opt, module)
    logical = logical_parameters(module)
    if sorted(saved["names"]) != sorted(n for n, _ in logical):
        raise ValueError("the saved optimizer state is of other parameters")
    state = {}
    for name, t in logical:
        s = saved["state"].get(name)
        if s is None:
            continue
        if isinstance(t, Shards):
            for p, (a, b) in zip(t, t.spans):
                state[index[id(p)]] = {
                    k: (v.narrow(t.dim, a, b - a).to(p.device)
                        if torch.is_tensor(v) and v.ndim else v)
                    for k, v in s.items()}
        else:
            state[index[id(t)]] = s
    opt.load_state_dict({"state": state, "param_groups": [
        {**g, "params": list(range(len(index)))} for g in saved["param_groups"]]})
