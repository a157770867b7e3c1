"""Multi-process start-up (port of vtoonify_tpu/parallel/multihost.py): the
launcher-side half of the reference's torch.distributed stack
(train_vtoonify_d.py:446-452's `dist.init_process_group` and its env-var
rank plumbing).

`initialize()` resolves the job the way the JAX package does: explicit
arguments first, then the VTOONIFY_* variables, then the launcher's
environment (`torchrun` and `torch.distributed.launch` export MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK), PyTorch's counterpart of
JAX's cluster auto-detection. A manual launch of one process per card:

    VTOONIFY_COORDINATOR=host0:9876 VTOONIFY_NUM_PROCESSES=4 \\
    VTOONIFY_PROCESS_ID=$RANK python -m vtoonify_tpu_torch.cli.train_d --multihost ...

The process group's backend follows the device the caller chose: NCCL for
the card, gloo for the CPU. A failing NCCL start raises; nothing retries on
gloo. `backend` overrides the choice (gloo with CUDA tensors runs two ranks
on one card, which NCCL refuses).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from vtoonify_tpu_torch import resolve_device

ENV_COORDINATOR = "VTOONIFY_COORDINATOR"
ENV_NUM_PROCESSES = "VTOONIFY_NUM_PROCESSES"
ENV_PROCESS_ID = "VTOONIFY_PROCESS_ID"


def _env_int(name) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               device=None, backend: Optional[str] = None,
               tp: int = 1) -> torch.device:
    """Join the job's process group; returns this process's device.

    Resolution order: explicit arguments > VTOONIFY_COORDINATOR /
    VTOONIFY_NUM_PROCESSES / VTOONIFY_PROCESS_ID > the launcher's
    MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK. Ranks given without a
    coordinator raise ValueError, as does a job with neither. `device`: None
    or "cuda" for the card, where the process takes cuda:LOCAL_RANK (the
    argument, else LOCAL_RANK, else the rank modulo the visible cards), or
    with `tp` > 1 the first of its row of tp cards, cuda:LOCAL_RANK * tp;
    "cpu" for the CPU."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = _env_int(ENV_PROCESS_ID)
    if coordinator_address is None and num_processes is None and process_id is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
            num_processes = _env_int("WORLD_SIZE")
            process_id = _env_int("RANK")
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "multihost.initialize: num_processes/process_id were given "
                "without a coordinator address — pass --coordinator host:port "
                f"(or set {ENV_COORDINATOR})")
        raise ValueError(
            "multihost.initialize: no coordinator address — pass --coordinator "
            f"host:port with --num_processes and --process_id (or set "
            f"{ENV_COORDINATOR}), or start the processes with torchrun")
    if num_processes is None or process_id is None:
        raise ValueError(f"multihost.initialize: coordinator {coordinator_address} "
                         "needs num_processes and process_id")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = process_id % max(torch.cuda.device_count() // tp, 1)
        device = torch.device("cuda", local_rank * tp)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id)
    return device


def launched() -> bool:
    """Whether a launcher (torchrun, torch.distributed.launch) started this
    process as one rank of a job."""
    return bool(os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
