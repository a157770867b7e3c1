"""Collectives over the job's process group (port of
vtoonify_tpu/parallel/collectives.py; the reference's
model/stylegan/distributed.py).

Every helper is a no-op (or the identity) with no process group, so one code
path serves one process and many. In a group of one rank the gradient and
metric reductions run (exactly: a sum over one rank, divided by one), which
is how a job on one card measures their cost; the batch-coupled helpers
(`gather_batch`, `local_rows`, `mean_over_ranks`) stay the identity there,
so the autograd graph, and with it every number, is the one process's. The
collectives are
`all_reduce` and `broadcast` only: NCCL, gloo on the CPU and gloo with CUDA
tensors all run them (gloo has no `all_gather` of CUDA tensors), so a
gather is an all-reduce sum of a zero-filled buffer in which each rank
fills its own rows. Half and bfloat16 tensors are reduced in float32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from vtoonify_tpu_torch.parallel.mesh import batch_not_divisible


def active() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def spans_ranks() -> bool:
    """Whether the batch is split over more than one rank."""
    return get_world_size() > 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    return (dist.get_world_size() if dist.is_available() and dist.is_initialized()
            else 1)


def synchronize() -> None:
    """A barrier across ranks (distributed.py:19-31)."""
    if get_world_size() > 1:
        dist.barrier()


def _all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of x (a new tensor in x's dtype)."""
    wide = x.dtype in (torch.float16, torch.bfloat16)
    y = x.float() if wide else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y.to(x.dtype) if wide else y


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks (distributed.py:44-54)."""
    return _all_reduce_sum(x) if active() else x


def reduce_loss_dict(loss_dict: dict) -> dict:
    """The mean over ranks of a dict of scalars, stacked in sorted-key order
    into one tensor (distributed.py:104-126)."""
    if not active() or not loss_dict:
        return loss_dict
    keys = sorted(loss_dict)
    stacked = torch.stack([torch.as_tensor(loss_dict[k]).float() for k in keys])
    reduced = _all_reduce_sum(stacked.detach()) / get_world_size()
    return {k: reduced[i] for i, k in enumerate(keys)}


def all_gather_tree(tree):
    """Every tensor leaf gathered along a new leading axis (world, ...)
    (distributed.py:69-101, without the pickles)."""
    return tree_map(lambda a: gather_batch(a[None]), tree)


def gather_grad(grads):
    """The mean over ranks of a list of gradients (distributed.py:57-66):
    one flattened all-reduce bucket per dtype and device (a weight split
    over a 'tp' row has a gradient per shard, each on its shard's device).
    None entries stay None."""
    if not active():
        return list(grads)
    out = list(grads)
    world = get_world_size()
    buckets: dict = {}
    for i, g in enumerate(out):
        if g is not None:
            buckets.setdefault((g.dtype, g.device), []).append(i)
    for idx in buckets.values():
        flat = _all_reduce_sum(torch.cat([out[i].reshape(-1) for i in idx])) / world
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    return out


def broadcast_modules(*modules, src: int = 0) -> None:
    """Every parameter and buffer of `modules` set to rank `src`'s, in
    place (the replicas' common start)."""
    if not active():
        return
    with torch.no_grad():
        for m in modules:
            for t in [*m.parameters(), *m.buffers()]:
                dist.broadcast(t.data, src)


class _GatherRows(torch.autograd.Function):
    """Each rank's rows -> the global batch on every rank. Its adjoint is
    `_ReduceRows` and the other way round, so it is differentiable to any
    order (R1's double backward goes through both)."""

    @staticmethod
    def forward(ctx, x):
        b = x.shape[0]
        buf = x.new_zeros((get_world_size() * b, *x.shape[1:]))
        buf[get_rank() * b:(get_rank() + 1) * b] = x
        return _all_reduce_sum(buf)

    @staticmethod
    def backward(ctx, g):
        return _ReduceRows.apply(g)


class _ReduceRows(torch.autograd.Function):
    """The gradient of the global batch, summed over ranks, at this rank's
    rows: every rank's loss reaches every row through the batch statistic."""

    @staticmethod
    def forward(ctx, g):
        b = g.shape[0] // get_world_size()
        r = get_rank()
        return _all_reduce_sum(g.contiguous())[r * b:(r + 1) * b].contiguous()

    @staticmethod
    def backward(ctx, gg):
        return _GatherRows.apply(gg)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch (world * B, ...) from each rank's B rows, in rank
    order, differentiable: the gradient of a loss on any rank reaches the
    rows it came from. Every rank must pass the same shape."""
    return _GatherRows.apply(x) if spans_ranks() else x


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (the rank's contiguous block, as
    JAX's P("dp") sharding splits the leading axis)."""
    if not spans_ranks():
        return x
    world = get_world_size()
    if x.shape[0] % world:
        raise ValueError(batch_not_divisible(x.shape[0], world, "world size"))
    b = x.shape[0] // world
    return x[get_rank() * b:(get_rank() + 1) * b]


class _MeanOverRanks(torch.autograd.Function):
    """The mean over ranks; self-adjoint (each rank's loss reaches each
    rank's input with weight 1 / world)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_sum(x) / get_world_size()

    @staticmethod
    def backward(ctx, g):
        return _MeanOverRanks.apply(g)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of x, differentiable (a batch statistic of the
    global batch from each rank's mean over its equal share of it)."""
    return _MeanOverRanks.apply(x) if spans_ranks() else x
