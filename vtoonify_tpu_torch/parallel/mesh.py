"""Device meshes in one process (port of vtoonify_tpu/parallel/mesh.py).

JAX shards one logical array over a `jax.sharding.Mesh`; the port places
modules per device and splits the work over them: along 'dp' the batch's
leading axis (frame-parallel serving, `ToonifyPipeline(mesh=make_mesh(...))`,
a copy of the modules per dp row), along 'tp' the wide layers' output
channels within a row (`parallel.tensor`: `make_mesh(n, tp=k)`, the
wide weights split over the row's k devices by `param_partition_spec`),
along 'sp' each frame's rows (`ToonifyPipeline(mesh=make_spatial_mesh(...))`,
the halos and global means in `parallel.spatial`). Training across cards
runs one process per rank instead (`parallel.multihost`,
`parallel.collectives`), each rank a row of `--tp` cards.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

def batch_not_divisible(batch: int, n: int, what: str = "dp width") -> str:
    """The message for a batch that n replicas or ranks cannot split
    evenly."""
    return f"batch {batch} is not divisible by {what} {n}"


@dataclass(frozen=True)
class Mesh:
    """`devices` along `axis`, 'dp' or 'sp' (the same device may appear
    twice); with 'dp', rows of `tp` devices in JAX's row-major order
    (`reshape(n // tp, tp)`). `shape` as a JAX mesh reports it."""
    devices: tuple
    axis: str = "dp"
    tp: int = 1

    @property
    def shape(self) -> dict:
        if self.axis == "sp":
            return {"sp": len(self.devices)}
        return {"dp": len(self.devices) // self.tp, "tp": self.tp}

    @property
    def rows(self) -> list:
        """The devices of each dp row: its 'tp' devices, in order."""
        k = self.tp
        return [self.devices[i:i + k] for i in range(0, len(self.devices), k)]


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
    """The first `n_devices` of `devices` (default: every visible card) as
    a (dp, tp) mesh: n // tp rows of tp devices. A count tp does not divide
    is refused, as JAX's make_mesh refuses it."""
    mesh = _mesh("make_mesh", n_devices, devices, "dp")
    n = len(mesh.devices)
    if tp < 1 or n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return Mesh(mesh.devices, "dp", tp)


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


def param_partition_spec(t: torch.Tensor, min_channels: int = 256,
                         name: str = "weight") -> tuple:
    """JAX's TP rule in the port's layouts: the spec of parameter `name`,
    'tp' on the axis `parallel.tensor.partition_dim` splits (the output
    channels of a conv's OIHW or a linear's (out, in) weight with at least
    `min_channels` of them; an image-like leaf's channels), the empty spec
    (replicated) for everything else."""
    from vtoonify_tpu_torch.parallel.tensor import partition_dim

    d = partition_dim(name, t, min_channels)
    return () if d is None else tuple("tp" if i == d else None for i in range(t.ndim))


def shard_params(module, mesh: Mesh, tp: bool = False, min_channels: int = 256) -> list:
    """A copy of `module` per device of the mesh, in the order of
    `mesh.devices` (a device named twice gets two copies); with `tp`, one
    copy per dp row with its wide parameters split over the row's devices
    (`parallel.tensor.shard_module`; a width tp does not divide is
    refused)."""
    if not tp:
        return [copy.deepcopy(module).to(d) for d in mesh.devices]
    from vtoonify_tpu_torch.parallel.tensor import shard_module

    return [shard_module(copy.deepcopy(module), row, min_channels) for row in mesh.rows]


def shard_batch(mesh: Mesh, batch: int) -> list:
    """The rows of a batch each dp row takes: equal contiguous slices, in
    row order. A batch that 'dp' does not divide is refused, as JAX's
    device_put onto P('dp') refuses it."""
    if mesh.axis != "dp":
        raise ValueError(f"shard_batch: a mesh along '{mesh.axis}' splits rows, "
                         "not frames (shard_spatial)")
    n = mesh.shape["dp"]
    if batch % n:
        raise ValueError(batch_not_divisible(batch, n))
    k = batch // n
    return [slice(i * k, (i + 1) * k) for i in range(n)]


def shard_array_batch(x, mesh: Mesh) -> list:
    """x's leading axis split over 'dp': one chunk on each row's first
    device."""
    return [torch.as_tensor(x[s], device=r[0])
            for s, r in zip(shard_batch(mesh, len(x)), mesh.rows)]


def shard_process_local_batch(x_global):
    """This rank's rows of a global batch (multi-process feeding: the
    reference's DistributedSampler split); the whole batch in one
    process. A batch the world size does not divide is refused."""
    from vtoonify_tpu_torch.parallel import collectives as C

    return C.local_rows(x_global)
