"""Device meshes for data parallelism in one process (port of
vtoonify_tpu/parallel/mesh.py).

JAX shards one logical array over a `jax.sharding.Mesh`; the port keeps a
replica of each module per device along `dp` and splits the batch's leading
axis over them (frame-parallel serving: `ToonifyPipeline(mesh=...)`).
Training across cards runs one process per card instead
(`parallel.multihost`, `parallel.collectives`). GSPMD tensor (`tp > 1`) and
spatial (`make_spatial_mesh`, `shard_spatial`) partitioning are not ported
(ROADMAP.md, north star): they raise NotImplementedError.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

_NOT_PORTED = ("GSPMD tensor and spatial partitioning are TPU layouts the "
               "north star leaves out (ROADMAP.md); vtoonify_tpu_torch has "
               "data parallelism over 'dp' only")


def batch_not_divisible(batch: int, n: int, what: str = "dp width") -> str:
    """The message for a batch that n replicas or ranks cannot split
    evenly."""
    return f"batch {batch} is not divisible by {what} {n}"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `devices` along 'dp' (the same device may appear twice);
    `shape` as a JAX mesh reports it."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": 1}


def _visible_cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass devices=[...] to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, devices=None) -> Mesh:
    """The first `n_devices` of `devices` (default: every visible card)
    along 'dp'."""
    if tp != 1:
        raise NotImplementedError(f"make_mesh(tp={tp}): {_NOT_PORTED}")
    devices = [torch.device(d) for d in
               (devices if devices is not None else _visible_cards())]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devices))


def make_spatial_mesh(n_devices: Optional[int] = None, devices=None):
    raise NotImplementedError(f"make_spatial_mesh: {_NOT_PORTED}")


def shard_spatial(mesh, ndim: int = 4):
    raise NotImplementedError(f"shard_spatial: {_NOT_PORTED}")


def replicated(mesh: Mesh) -> tuple:
    """Where a replicated value lives: on every device of the mesh."""
    return mesh.devices


def param_partition_spec(t: torch.Tensor) -> tuple:
    """Every parameter is replicated along 'dp' (the empty spec); the JAX
    package's channel split over 'tp' is not ported."""
    return ()


def shard_params(module, mesh: Mesh) -> list:
    """A replica of `module` on each device of the mesh, in the order of
    `mesh.devices` (a device named twice gets two replicas)."""
    return [copy.deepcopy(module).to(d) for d in mesh.devices]


def shard_batch(mesh: Mesh, batch: int) -> list:
    """The rows of a batch each device along 'dp' takes: equal contiguous
    slices, in device order. A batch that 'dp' does not divide is refused,
    as JAX's device_put onto P('dp') refuses it."""
    n = len(mesh.devices)
    if batch % n:
        raise ValueError(batch_not_divisible(batch, n))
    k = batch // n
    return [slice(i * k, (i + 1) * k) for i in range(n)]


def shard_array_batch(x, mesh: Mesh) -> list:
    """x's leading axis split over 'dp': one chunk on each device."""
    return [torch.as_tensor(x[s], device=d)
            for s, d in zip(shard_batch(mesh, len(x)), mesh.devices)]


def shard_process_local_batch(x_global):
    """This rank's rows of a global batch (multi-process feeding: the
    reference's DistributedSampler split); the whole batch in one
    process. A batch the world size does not divide is refused."""
    from vtoonify_tpu_torch.parallel import collectives as C

    return C.local_rows(x_global)
