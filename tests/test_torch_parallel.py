"""The port's data parallelism on the CPU (vtoonify_tpu_torch/parallel,
`ToonifyPipeline(mesh=...)`, the train steps and trainer CLIs under a
process group) against the JAX package and against one process.

Multi-process cases run real gloo jobs: each rank is a subprocess of
tests/_torch_parallel_worker.py (or a trainer CLI) on a free localhost port,
waited on for at most 120 s; any failure or the deadline kills the other
ranks, so a rank that raises can never leave its peer blocked in a
collective past it. The jobs start from a pool of at most SLOTS live
processes when the module starts, and run beside the in-process JAX work.

Tolerances: the collectives and the stddev layer, 1e-6 of the largest value
(float32 sums in another order); the frame-parallel pipeline bit-equal to
the one-device pipeline and within the pipeline tests' float32 bound (1
uint8 LSB, mean 0.05) of JAX's `ToonifyPipeline(mesh=make_mesh(2))`; the
2-rank steps and CLI checkpoints within 1e-5 relative L2 of one process on
the same global batch (tests/test_torch_train_step.py and
tests/test_torch_train_t.py hold the one-process steps to JAX's).
"""

import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tests._torch_parallel_worker import (
    MASK_D_S,
    STDDEV_BATCHES,
    collectives_inputs,
    loss_inputs,
    stddev_inputs,
)
from tests.test_torch_models import _vtoonify_pair
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.models import generator as JG
from vtoonify_tpu.parallel import collectives as JC
from vtoonify_tpu.parallel import mesh as JM
from vtoonify_tpu.pipeline import toonify as JT
from vtoonify_tpu.train import losses as JLS
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.parallel import mesh as M
from vtoonify_tpu_torch.parallel import spatial as S
from vtoonify_tpu_torch.pipeline import toonify as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
DEADLINE_S = 120  # a job's processes, from the wait's start
QUEUE_DEADLINE_S = 4 * DEADLINE_S  # a job's start, from the wait's start
SLOTS = 6  # processes alive at once


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "VTOONIFY_COORDINATOR", "VTOONIFY_NUM_PROCESSES", "VTOONIFY_PROCESS_ID"):
        env.pop(k, None)
    return env


class Job:
    """Processes started together (a job's ranks rendezvous) once the
    module's Pool has room for all of them, and waited on together for at
    most DEADLINE_S from the wait's start; a failure or the deadline kills
    them all. Their output goes to files, so a rank never blocks on a full
    pipe."""

    def __init__(self, name, argvs, log_dir, cwds=None):
        self.argvs, self.cwds = argvs, cwds or [None] * len(argvs)
        self.logs = [log_dir / f"{name}_{i}.log" for i in range(len(argvs))]
        self.procs = []
        self.started = threading.Event()

    def start(self):
        for a, c, log in zip(self.argvs, self.cwds, self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(a, cwd=c, env=_env(), stdout=f,
                                                   stderr=subprocess.STDOUT))
        self.started.set()

    def alive(self) -> int:
        return sum(p.poll() is None for p in self.procs)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self):
        """[(returncode, output)] of every process."""
        if not self.started.wait(QUEUE_DEADLINE_S):
            return [(None, "never started")]
        outs = []
        t0 = time.monotonic()
        try:
            for p, log in zip(self.procs, self.logs):
                p.wait(timeout=max(DEADLINE_S - (time.monotonic() - t0), 1))
                outs.append((p.returncode, log.read_text()))
                if p.returncode:
                    break
        except subprocess.TimeoutExpired:
            outs.append((None, "deadline"))
        finally:
            self.kill()
        return outs

    def check(self):
        outs = self.wait()
        for rc, out in outs:
            assert rc == 0, f"rc {rc}:\n{out[-3000:]}"
        assert len(outs) == len(self.procs)


class Pool:
    """Starts the jobs in the order given (then those `add`ed), each as
    soon as at most SLOTS processes would then be alive (a later job that
    fits goes before an earlier one that does not): the module's jobs share
    the host's cores and memory instead of all running at once."""

    def __init__(self, jobs, slots=SLOTS):
        self.pending, self.running, self.slots = list(jobs), [], slots
        self.lock, self.stop = threading.Lock(), threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def add(self, jobs):
        with self.lock:
            self.pending += jobs

    def _run(self):
        while not self.stop.is_set():
            busy = sum(j.alive() for j in self.running)
            with self.lock:
                for job in list(self.pending):
                    if busy + len(job.argvs) <= self.slots:
                        job.start()
                        self.running.append(job)
                        self.pending.remove(job)
                        busy += len(job.argvs)
            time.sleep(0.2)

    def close(self):
        self.stop.set()
        self.thread.join()
        for job in self.running:
            job.kill()


def _ranks(case, out_dir, world=2):
    port = _free_port()
    return [[sys.executable, WORKER, case, str(r), str(world), str(port), str(out_dir)]
            for r in range(world)]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The module's worker jobs, in a Pool, first the ones the first tests
    wait on and the longest: the collectives and the batch statistics (the
    stddev layer, the mask loss, the path length's mean) over 2 ranks; the
    --tiny D and T steps, each over 2 ranks (in `ranks/`) and alone in one
    process (in `one/`); the trainer CLIs' runs (_cli_jobs)."""
    out = tmp_path_factory.mktemp("ranks")
    for d in ("ranks", "one", "cli", "logs"):
        (out / d).mkdir()
    job = lambda name, argvs, cwds=None: Job(name, argvs, out / "logs", cwds)  # noqa: E731
    started = {
        "collectives": job("collectives", _ranks("collectives", out)),
        "batch_stats": job("batch_stats", _ranks("batch_stats", out)),
        **{f"steps_{w}_one": job(f"steps_{w}_one", [
            [sys.executable, WORKER, f"steps_{w}", "0", "1", "0", str(out / "one")]])
           for w in ("d", "t")},
        **{f"steps_{w}_ranks": job(f"steps_{w}_ranks", _ranks(f"steps_{w}", out / "ranks"))
           for w in ("d", "t")},
    }
    pool = Pool([started[k] for k in ("collectives", "batch_stats", "steps_d_one",
                                      "steps_d_ranks", "steps_t_one", "steps_t_ranks")])
    _write_pretrain_files(out / "cli")  # while the first jobs run
    cli = {k: job(k, *argvs_cwds) for k, argvs_cwds in _cli_jobs(out / "cli").items()}
    started.update(cli)
    pool.add([cli[k] for k in ("cli_train_d_one", "cli_train_d_two", "cli_train_t_one",
                               "cli_train_t_two", "cli_refused")])
    yield out, started
    pool.close()
    shutil.rmtree(out, ignore_errors=True)


def _load(out, case, rank):
    return dict(np.load(out / f"{case}_{rank}.npz"))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _shard_map(fn, **kw):
    """fn under shard_map over 2 of the suite's virtual CPU devices, the
    leading axis of every input split over 'dp', the output replicated."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("dp"), out_specs=P(), **kw))


# ---------------------------------------------------------------------------
# collectives and the cross-rank minibatch stddev


def test_collectives_match_jax_over_two_ranks(jobs):
    """reduce_loss_dict, reduce_sum, all_gather_tree and gather_grad over 2
    gloo ranks against JAX's under shard_map on 2 devices, fed the same
    per-rank values; both ranks hold the same results."""
    out, started = jobs
    started["collectives"].check()
    ranks = [_load(out, "collectives", r) for r in range(2)]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    got = ranks[0]
    assert int(got["world"]) == 2
    inp = [collectives_inputs(r) for r in range(2)]
    stack = lambda f: jax.tree_util.tree_map(lambda *a: np.stack(a), *map(f, inp))  # noqa: E731

    losses = _shard_map(lambda d: JC.reduce_loss_dict(
        {k: v[0] for k, v in d.items()}))(stack(lambda i: i["losses"]))
    for k, v in losses.items():
        assert _rel(got[f"loss_{k}"], v) <= 1e-6, k
    assert _rel(got["sum"], _shard_map(lambda x: JC.reduce_sum(x[0]))(stack(
        lambda i: i["x"]))) <= 1e-6
    # (all_gather's output is replicated; shard_map cannot infer it)
    tree = _shard_map(lambda t: JC.all_gather_tree(jax.tree_util.tree_map(
        lambda a: a[0], t)), check_vma=False)(stack(lambda i: i["tree"]))
    np.testing.assert_array_equal(got["gather_a"], tree["a"])
    np.testing.assert_array_equal(got["gather_b"], tree["b"][0])
    # JAX's gradients in float32 (x64 is off in the suite): the float64
    # bucket is held to them at float32 precision
    grads = _shard_map(lambda g: JC.gather_grad([a[0] for a in g]))(
        stack(lambda i: i["grads"]))
    for i, want in enumerate(grads):
        assert got[f"grad{i}"].dtype == inp[0]["grads"][i].dtype
        assert _rel(got[f"grad{i}"], want) <= 1e-6, i


def test_minibatch_stddev_across_ranks_matches_jax(jobs):
    """The stddev map and its input gradient (of sum(map * w)) over 2 gloo
    ranks, each with its rows of global batches of 2, 4 and 8, against
    JAX's G.minibatch_stddev on the global batch and against the port's
    layer in one process on the concatenated batch."""
    out, started = jobs
    started["batch_stats"].check()
    ranks = [_load(out, "batch_stats", r) for r in range(2)]
    for b in STDDEV_BATCHES:
        x, w = stddev_inputs(b)
        y_got = np.concatenate([r[f"y{b}"] for r in ranks])
        g_got = np.concatenate([r[f"g{b}"] for r in ranks])

        def loss(xh):
            return (JG.minibatch_stddev(xh) * jnp.moveaxis(w, 1, -1)).sum()

        xh = jnp.moveaxis(x, 1, -1)
        y_jax = np.moveaxis(np.asarray(JG.minibatch_stddev(xh)), -1, 1)
        g_jax = np.moveaxis(np.asarray(jax.grad(loss)(xh)), -1, 1)
        xt = torch.from_numpy(x).requires_grad_()
        y_one = G.minibatch_stddev(xt)
        (g_one,) = torch.autograd.grad((y_one * torch.from_numpy(w)).sum(), xt)
        for got, want, one in ((y_got, y_jax, y_one), (g_got, g_jax, g_one)):
            assert _rel(got, want) <= 1e-6, b
            assert _rel(got, one.detach().numpy()) <= 1e-6, b
        assert np.abs(g_got).max() > 0


def test_batch_statistics_in_losses_match_jax(jobs):
    """Over 2 gloo ranks, the losses' batch statistics are the global
    batch's: the mask loss (the ranks' means on both sides of its
    threshold) equals JAX's mask_loss on the global batch on every rank,
    and the gradient at each rank's rows, over the world size (the
    gradient mean's factor), equals JAX's; the path-length penalty
    (averaged over the ranks), its new mean and the mean over the ranks of
    its weight gradient equal JAX's g_path_regularize on the global
    batch. 1e-6 of the largest value (the mask loss, a mean minus a
    threshold near 0.3: 1e-6 absolute)."""
    out, started = jobs
    started["batch_stats"].check()
    ranks = [_load(out, "batch_stats", r) for r in range(2)]
    inp = loss_inputs()
    masks = [jnp.moveaxis(m, 1, -1) for m in inp["masks"]]
    want, grads = jax.value_and_grad(lambda ms: JLS.mask_loss(ms, MASK_D_S, 1.0))(masks)
    for r in ranks:  # a difference of a mean and a threshold near 0.3
        assert abs(float(r["mask_loss"]) - float(want)) <= 1e-6
    assert float(want) > 0.01
    for i, g in enumerate(grads):
        got = np.concatenate([r[f"mask_grad{i}"] for r in ranks]) / 2
        assert _rel(got, np.moveaxis(np.asarray(g), -1, 1)) <= 1e-6, i

    noise = jnp.moveaxis(inp["noise"], 1, -1)

    def penalty(w):
        return JLS.g_path_regularize(lambda lat: jnp.tanh(lat @ w)[..., None],
                                     jnp.asarray(inp["lat"]), 0.5, noise=noise)

    pen, mean, lengths = penalty(jnp.asarray(inp["w"]))
    gw = jax.grad(lambda w: penalty(w)[0])(jnp.asarray(inp["w"]))
    for r in ranks:
        assert _rel(r["path_penalty"], pen) <= 1e-6
        assert _rel(r["path_mean"], mean) <= 1e-6
        assert _rel(r["path_grad_w"], gw) <= 1e-6
    assert _rel(np.concatenate([r["path_lengths"] for r in ranks]), lengths) <= 1e-6


# ---------------------------------------------------------------------------
# frame-parallel serving, and the mesh helpers


def test_mesh_helpers_match_jax():
    """make_mesh's and make_spatial_mesh's shapes as JAX's; the batch split
    and its refusal; the rows round-trip through shard_array_spatial; a
    (dp, tp) mesh is built, and a count tp does not divide refused."""
    mesh = M.make_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == dict(JM.make_mesh(2).shape)
    assert M.replicated(mesh) == (torch.device("cpu"),) * 2
    assert M.param_partition_spec(torch.zeros(3, 3, 512, 512)) == ()
    x = np.arange(12).reshape(6, 2)
    chunks = M.shard_array_batch(x, mesh)
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), x)
    assert [len(c) for c in chunks] == [3, 3]
    assert M.shard_process_local_batch(x) is x  # one process: the whole batch
    with pytest.raises(ValueError, match="not divisible by dp width 2"):
        M.shard_batch(mesh, 5)
    for n in (2, 8):
        sp = M.make_spatial_mesh(devices=["cpu"] * n)
        assert sp.shape == dict(JM.make_spatial_mesh(n).shape)
        x = np.arange(2 * 13 * 3).reshape(2, 13, 3, 1)
        slabs = M.shard_array_spatial(x, sp)
        assert [p.shape[1] for p in slabs.parts] == [s.stop - s.start
                                                     for s in M.shard_spatial(sp, 13)]
        np.testing.assert_array_equal(S.gather(slabs).numpy(), x)
    tp = M.make_mesh(devices=["cpu"] * 4, tp=2)  # a 2-D mesh: 2 rows of 2
    assert tp.shape == dict(JM.make_mesh(4, tp=2).shape) == {"dp": 2, "tp": 2}
    assert [len(r) for r in tp.rows] == [2, 2]
    with pytest.raises(ValueError, match="4 devices not divisible by tp=3"):
        M.make_mesh(devices=["cpu"] * 4, tp=3)
    replicas = M.shard_params(torch.nn.Linear(2, 2), mesh)
    assert len(replicas) == 2 and replicas[0] is not replicas[1]


def test_frame_parallel_pipeline_matches_jax():
    """The tiny VToonify-D (tests/test_torch_models.py's, weights carried
    from JAX) on 4 seeded 32 px frames, float32: the port's pipeline over a
    mesh of two CPU replicas is bit-equal to the port without a mesh, with
    its BiSeNet (the port's seeded init) and with given parsing maps; with
    the maps it is within 1 LSB (mean 0.05) of JAX's pipeline over
    make_mesh(2); a batch of 3 is refused."""
    jcfg, jp, cfg, p = _vtoonify_pair("dualstylegan")
    bp = B.init_bisenet(generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(12)
    frames = rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    x_p = rng.randn(4, 32, 32, 19).astype(np.float32) * 4
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    jpipe = JT.ToonifyPipeline(jp, jcfg, {}, dtype=jnp.float32, mesh=JM.make_mesh(2))
    ref = np.asarray(jpipe.process_batch_with_parsing(frames, x_p, jnp.asarray(s_w), 0.5))
    del jpipe
    one = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, device="cpu")
    dp = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32,
                           mesh=M.make_mesh(devices=["cpu", "cpu"]))
    assert len(dp._replicas) == 2 and dp._replicas[1][1] is not dp.vt
    got = dp.process_batch_with_parsing(frames, x_p, s_w, 0.5)
    assert torch.equal(got, one.process_batch_with_parsing(frames, x_p, s_w, 0.5))
    got = got.numpy()
    assert got.shape == (4, 128, 128, 3) and got.dtype == np.uint8 and got.std() > 10
    diff = np.abs(got.astype(np.int32) - ref)
    assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())
    assert torch.equal(dp.process_batch(frames, s_w, 0.5), one.process_batch(frames, s_w, 0.5))
    with pytest.raises(ValueError, match="not divisible by dp width 2"):
        dp.process_batch(frames[:3], s_w, 0.5)


def test_engine_over_a_mesh_tops_up_the_last_batch():
    """The video engine over a frame-parallel pipeline of two CPU replicas:
    7 frames at batch 4 with precomputed parsing maps (the last batch, 3
    frames, topped up with its last frame and map for the split, which is
    not written) give the frames of the one-device engine, bit for bit. (At
    least 2 frames a replica: a batch of one frame takes the unfolded style
    form, which rounds differently.)"""
    from tests.test_torch_pipeline import _pipe
    from vtoonify_tpu_torch.pipeline import video

    pipe, s_w = _pipe()
    dp = T.ToonifyPipeline(pipe.vt, pipe.vt_cfg, pipe.parsing, dtype=pipe.dtype,
                           mesh=M.make_mesh(devices=["cpu", "cpu"]))
    rng = np.random.RandomState(23)
    frames = rng.randint(0, 256, (7, 32, 32, 3)).astype(np.uint8)
    maps = rng.randn(7, 32, 32, 19).astype(np.float32) * 4
    written = []
    for p in (pipe, dp):
        writer = video.MemoryWriter()
        result = video.toonify_frames(p, ((25.0, f) for f in frames), lambda fps, size: writer,
                                      scale_image=False, batch_size=4, s_w=s_w,
                                      parsing_maps=maps)
        assert result.frames_written == 7 == len(writer.frames)
        written.append(np.stack(writer.frames))
    np.testing.assert_array_equal(written[1], written[0])


# ---------------------------------------------------------------------------
# the train steps and the trainer CLIs over 2 ranks


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_train_steps_two_ranks_match_one_process(jobs):
    """The --tiny D stage-2 step and the --tiny T stage-2 step at global
    batch 4: over 2 gloo ranks of 2 rows each against one process on the
    whole batch, the gradients the optimizers applied (the mean over the
    ranks), the new parameters of the student and the discriminator, the
    EMA and the reduced metrics within 1e-5 relative L2; both ranks hold
    the same values."""
    out, started = jobs
    for w in ("d", "t"):
        started[f"steps_{w}_ranks"].check()
        started[f"steps_{w}_one"].check()
    ranks = [{**_load(out / "ranks", "steps_d", r), **_load(out / "ranks", "steps_t", r)}
             for r in range(2)]
    ref = {**_load(out / "one", "steps_d", 0), **_load(out / "one", "steps_t", 0)}
    for f in out.glob("*/steps*.npz"):  # ~0.2 GB each
        f.unlink()
    assert set(ranks[0]) == set(ref)
    for k, want in ref.items():
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        assert np.all(np.isfinite(ranks[0][k])), k
        if "_metric_" not in k:
            assert _rel_l2(ranks[0][k], want) <= 1e-5, (k, _rel_l2(ranks[0][k], want))
    for w in ("d", "t"):
        keys = sorted(k for k in ref if k.startswith(f"{w}_metric_"))
        got = np.array([ranks[0][k] for k in keys])
        want = np.array([ref[k] for k in keys])
        assert _rel_l2(got, want) <= 1e-5, (w, dict(zip(keys, got)), dict(zip(keys, want)))


def _write_pretrain_files(root):
    """What the trainers' --pretrain stage reads, at --tiny, in the
    reference's formats (random weights)."""
    import chip_smoke
    from vtoonify_tpu_torch.convert.torch_export import export_dualstylegan, export_generator
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.models.dualstylegan import init_dualstylegan
    from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig

    g = torch.Generator().manual_seed(4)
    cfg = VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
    n = cfg.n_latent

    def g_ema(name, sd):
        torch.save({"g_ema": {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}}, str(root / name))

    g_ema("generator.pt", export_dualstylegan(init_dualstylegan(cfg.dualstylegan, g),
                                              cfg.dualstylegan))
    for name in ("stylegan.pt", "finetune.pt"):
        g_ema(name, export_generator(G.init_generator(cfg.generator, g), cfg.generator))
    torch.save(chip_smoke.bisenet_reference_state(init_bisenet(generator=g)),
               str(root / "faceparsing.pth"))
    np.save(str(root / "exstyle_code.npy"),
            {f"style{i}.png": (torch.randn((1, n, 512), generator=g) * 0.3).numpy()
             for i in range(3)}, allow_pickle=True)
    np.save(str(root / "directions.npy"), (torch.randn((4, n, 512), generator=g) * 0.1).numpy())


def _cli_jobs(root):
    """Both trainer CLIs' --pretrain stage at --tiny --cpu for 2 iterations
    at --batch 4, in one process and over 2 ranks (--multihost), each run in
    its own directory under `root`; and train_d at --batch 3 over 2 ranks.
    {job name: (argvs, cwds)}."""
    f = lambda name: str(root / name)  # noqa: E731
    common = ["--cpu", "--tiny", "--pretrain", "--iter", "2", "--name", "run",
              "--faceparsing_path", f("faceparsing.pth"),
              "--direction_path", f("directions.npy")]
    clis = {"train_d": ["--stylegan_path", f("generator.pt"),
                        "--exstyle_path", f("exstyle_code.npy")],
            "train_t": ["--stylegan_path", f("stylegan.pt"),
                        "--finetunegan_path", f("finetune.pt")]}
    jobs = {}
    for cli, extra in clis.items():
        port = _free_port()
        base = [sys.executable, "-m", f"vtoonify_tpu_torch.cli.{cli}", *common, *extra,
                "--batch", "4"]
        for where, args in (("one", [[]]), ("two", [
                ["--multihost", "--coordinator", f"127.0.0.1:{port}",
                 "--num_processes", "2", "--process_id", str(r)] for r in range(2)])):
            cwd = root / cli / where
            cwd.mkdir(parents=True, exist_ok=True)
            jobs[f"cli_{cli}_{where}"] = ([base + a for a in args], [cwd] * len(args))
    port = _free_port()
    refused = [[sys.executable, "-m", "vtoonify_tpu_torch.cli.train_d", *common,
                *clis["train_d"], "--batch", "3", "--multihost", "--coordinator",
                f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(r)]
               for r in range(2)]
    (root / "refused").mkdir()
    jobs["cli_refused"] = (refused, [root / "refused"] * 2)
    return jobs


def test_trainer_clis_over_two_ranks(jobs):
    """Both trainer CLIs' --pretrain stage at --tiny --cpu for 2 iterations
    at --batch 4: under --multihost with 2 gloo ranks the checkpoint is
    rank 0's alone and equals a one-process run's within 1e-5 relative L2;
    --batch 3 over 2 ranks exits."""
    out, started = jobs
    root = out / "cli"
    for cli in ("train_d", "train_t"):
        for where in ("one", "two"):
            started[f"cli_{cli}_{where}"].check()
    for rc, text in started["cli_refused"].wait():
        assert rc != 0 and "not divisible by world size 2" in text, text[-2000:]
    for cli in ("train_d", "train_t"):
        files = {w: sorted(os.listdir(root / cli / w / "checkpoint" / "run"))
                 for w in ("one", "two")}
        assert files["two"] == files["one"] == ["pretrain.ckpt", "pretrain_state.ckpt"]
        assert sorted(os.listdir(root / cli / "two")) == ["checkpoint", "log"]
        assert os.listdir(root / cli / "two" / "log") == ["run"]
        one, two = (torch.load(root / cli / w / "checkpoint" / "run" / "pretrain.ckpt",
                               weights_only=False) for w in ("one", "two"))
        flat = [np.concatenate([np.asarray(v, np.float64).ravel()
                                for _, v in sorted(_leaves(c))]) for c in (one, two)]
        assert _rel_l2(flat[1], flat[0]) <= 1e-5, cli


def _leaves(tree, prefix=""):
    """(path, array) of every tensor or array in a nested dict / list."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return [(prefix, np.asarray(tree))]
    return []
