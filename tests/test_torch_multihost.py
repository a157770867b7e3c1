"""The port's multi-process start-up (vtoonify_tpu_torch/parallel/multihost.py)
against the JAX package's (vtoonify_tpu/parallel/multihost.py): the same
arguments and environment resolve to the same coordinator, process count and
rank, and ranks without a coordinator raise the same ValueError. The process
group itself is not started here (tests/test_torch_parallel.py starts real
ones); `init_process_group` and `jax.distributed.initialize` are replaced by
recorders."""

import jax
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.parallel import multihost as JM
from vtoonify_tpu_torch.parallel import multihost as M

_ENV = ("VTOONIFY_COORDINATOR", "VTOONIFY_NUM_PROCESSES", "VTOONIFY_PROCESS_ID",
        "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.fixture
def recorded(monkeypatch):
    """A clean environment; both packages' start calls recorded."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    calls = {}

    def port_init(backend, init_method, world_size, rank):
        calls["port"] = (backend, init_method.removeprefix("tcp://"), world_size, rank)

    def jax_init(coordinator_address=None, num_processes=None, process_id=None):
        calls["jax"] = (coordinator_address, num_processes, process_id)

    monkeypatch.setattr(M.dist, "init_process_group", port_init)
    monkeypatch.setattr(jax.distributed, "initialize", jax_init)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)  # JAX's gloo switch
    return calls


@pytest.mark.parametrize("args,env", [
    (("h0:1234", 4, 2), {}),
    ((None, None, None), {"VTOONIFY_COORDINATOR": "h1:99",
                          "VTOONIFY_NUM_PROCESSES": "2", "VTOONIFY_PROCESS_ID": "1"}),
    # explicit arguments win over the environment
    (("h0:1234", 3, 0), {"VTOONIFY_COORDINATOR": "h1:99",
                         "VTOONIFY_NUM_PROCESSES": "2", "VTOONIFY_PROCESS_ID": "1"}),
    ((None, 2, None), {"VTOONIFY_COORDINATOR": "h1:99", "VTOONIFY_PROCESS_ID": "0"}),
])
def test_initialize_resolves_as_jax(recorded, monkeypatch, args, env):
    """Explicit arguments, then the VTOONIFY_* variables: the coordinator,
    count and rank JAX's initialize hands jax.distributed are the ones the
    port hands torch.distributed, with gloo for the CPU."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    JM.initialize(*args)
    assert M.initialize(*args, device="cpu") == torch.device("cpu")
    assert recorded["port"] == ("gloo", *recorded["jax"])


def test_initialize_reads_the_launchers_environment(recorded, monkeypatch):
    """torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, where JAX
    auto-detects its cluster; the VTOONIFY_* variables win over them."""
    for k, v in {"MASTER_ADDR": "10.0.0.5", "MASTER_PORT": "29500",
                 "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    assert M.launched()
    M.initialize(device="cpu")
    assert recorded["port"] == ("gloo", "10.0.0.5:29500", 8, 5)
    monkeypatch.setenv("VTOONIFY_COORDINATOR", "h1:99")
    monkeypatch.setenv("VTOONIFY_NUM_PROCESSES", "2")
    monkeypatch.setenv("VTOONIFY_PROCESS_ID", "1")
    M.initialize(device="cpu")
    assert recorded["port"] == ("gloo", "h1:99", 2, 1)


@pytest.mark.parametrize("kwargs", [dict(num_processes=2, process_id=0),
                                    dict(process_id=1), dict(num_processes=2)])
def test_initialize_rejects_ranks_without_coordinator(recorded, kwargs):
    """Ranks without a coordinator raise ValueError naming the coordinator,
    in both packages (tests/test_multihost.py holds JAX's), before any
    process group starts."""
    with pytest.raises(ValueError, match="coordinator"):
        JM.initialize(**kwargs)
    with pytest.raises(ValueError, match="coordinator"):
        M.initialize(**kwargs, device="cpu")
    assert "port" not in recorded and "jax" not in recorded


def test_initialize_without_a_job_raises(recorded):
    """No coordinator, no ranks, no launcher: the port names what to pass
    (JAX would try its cluster auto-detection), and the card is chosen only
    when a job is found."""
    assert not M.launched()
    with pytest.raises(ValueError, match="coordinator"):
        M.initialize(device="cpu")
    assert "port" not in recorded
