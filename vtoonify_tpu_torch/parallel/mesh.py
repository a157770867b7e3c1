"""Device meshes in one process (port of vtoonify_tpu/parallel/mesh.py).

JAX shards one logical array over a `jax.sharding.Mesh`; the port keeps a
replica of each module per device and splits the work over them: along
'dp' the batch's leading axis (frame-parallel serving,
`ToonifyPipeline(mesh=make_mesh(...))`), along 'sp' each frame's rows
(`ToonifyPipeline(mesh=make_spatial_mesh(...))`, the halos and global means
in `parallel.spatial`). Training across cards runs one process per card
instead (`parallel.multihost`, `parallel.collectives`). Tensor parallelism
(`tp > 1`) is the next slice of the port (ROADMAP.md, queue A) and raises
NotImplementedError.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

_TP_NOT_YET = ("tensor parallelism over 'tp' is not ported yet (ROADMAP.md, "
               "queue A: TP serving and training); vtoonify_tpu_torch splits "
               "frames over 'dp' and rows over 'sp'")


def batch_not_divisible(batch: int, n: int, what: str = "dp width") -> str:
    """The message for a batch that n replicas or ranks cannot split
    evenly."""
    return f"batch {batch} is not divisible by {what} {n}"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `devices` along `axis`, 'dp' or 'sp' (the same device
    may appear twice); `shape` as a JAX mesh reports it."""
    devices: tuple
    axis: str = "dp"

    @property
    def shape(self) -> dict:
        if self.axis == "sp":
            return {"sp": len(self.devices)}
        return {"dp": len(self.devices), "tp": 1}


def _visible_cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass devices=[...] to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(name, n_devices, devices, axis) -> Mesh:
    devices = [torch.device(d) for d in
               (devices if devices is not None else _visible_cards())]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{name}: {n_devices} devices asked for, "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError(f"{name}: no devices")
    return Mesh(tuple(devices), axis)


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, devices=None) -> Mesh:
    """The first `n_devices` of `devices` (default: every visible card)
    along 'dp'."""
    if tp != 1:
        raise NotImplementedError(f"make_mesh(tp={tp}): {_TP_NOT_YET}")
    return _mesh("make_mesh", n_devices, devices, "dp")


def make_spatial_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The first `n_devices` of `devices` (default: every visible card;
    raises when there is none) along 'sp': each frame's rows split over
    them."""
    return _mesh("make_spatial_mesh", n_devices, devices, "sp")


def shard_spatial(mesh: Mesh, height: int) -> list:
    """The rows of a frame of `height` rows each device along 'sp' takes:
    contiguous slices in device order, as even as they can be (the first
    height % n one row longer; with fewer rows than devices the last
    devices take none)."""
    from vtoonify_tpu_torch.parallel.spatial import partition

    return [slice(a, b) for a, b in partition(height, len(mesh.devices))]


def shard_array_spatial(x, mesh: Mesh):
    """The rows of NHWC frames x (axis 1, as JAX's P(None, 'sp')) split
    over 'sp': a `parallel.spatial.RowSharded` with one slab on each
    device."""
    from vtoonify_tpu_torch.parallel.spatial import shard_rows

    return shard_rows(x, mesh.devices, 1)


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
    if mesh.axis != "dp":
        raise ValueError(f"shard_batch: a mesh along '{mesh.axis}' splits rows, "
                         "not frames (shard_spatial)")
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
