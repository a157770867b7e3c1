"""One rank of a CPU data-parallel job of the port (gloo), for
tests/test_torch_parallel.py:

    python tests/_torch_parallel_worker.py CASE RANK WORLD PORT OUT_DIR

WORLD 1 runs the case in one process without a process group (the
reference the ranks are held to). Each case writes OUT_DIR/CASE_RANK.npz.
Imports torch and the port only.

    python tests/_torch_parallel_worker.py witness OUT_DIR

prints, as one JSON object, where the gap between a 2-rank D stage-2 step
of one row a rank (global batch 2, the flagship's split) and one process
comes from: the --tiny step over 2 ranks against one process in float32
and in float64, and the one-process step whose teacher synthesis runs a row
at a time (the ranks' batch size) against both.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from vtoonify_tpu_torch.parallel import collectives as C
from vtoonify_tpu_torch.parallel import multihost

STDDEV_BATCHES = (2, 4, 8)
STEP_BATCH = 4  # the global batch of the stage-2 steps


def collectives_inputs(rank):
    """Rank `rank`'s inputs of the collectives case (seeded per rank)."""
    rng = np.random.RandomState(100 + rank)
    return dict(
        losses={k: np.float32(rng.randn()) for k in ("g", "d", "gr", "msk")},
        x=rng.randn(3, 4).astype(np.float32),
        tree={"a": rng.randn(2, 3).astype(np.float32),
              "b": [rng.randn(5).astype(np.float32)]},
        grads=[rng.randn(3, 2).astype(np.float32), rng.randn(4).astype(np.float64),
               rng.randn(2, 2).astype(np.float32)])


def run_collectives(rank, out):
    inp = collectives_inputs(rank)
    t = torch.from_numpy
    losses = C.reduce_loss_dict({k: torch.tensor(v) for k, v in inp["losses"].items()})
    gathered = C.all_gather_tree({"a": t(inp["tree"]["a"]), "b": [t(inp["tree"]["b"][0])]})
    grads = C.gather_grad([t(g) for g in inp["grads"]])
    out.update({f"loss_{k}": v.numpy() for k, v in losses.items()})
    out.update(sum=C.reduce_sum(t(inp["x"])).numpy(), gather_a=gathered["a"].numpy(),
               gather_b=gathered["b"][0].numpy(),
               **{f"grad{i}": g.numpy() for i, g in enumerate(grads)})
    out["world"] = np.int64(C.get_world_size())
    C.synchronize()


def stddev_inputs(batch):
    """The global batch (NCHW) and the output weights of the stddev case."""
    rng = np.random.RandomState(batch)
    return (rng.randn(batch, 6, 3, 4).astype(np.float32),
            rng.randn(batch, 1, 3, 4).astype(np.float32))


MASK_D_S = 0.5  # the mask loss's threshold (1 - d_s)^2 0.9 + 0.1 = 0.325


def loss_inputs():
    """The global batch (4) of the mask loss and the path-length penalty:
    two masks whose rows have means on both sides of the threshold (rank 0's
    below, rank 1's above), latents, a linear map's weight and the
    penalty's noise."""
    rng = np.random.RandomState(17)
    lo, hi = rng.rand(2, 1, 4, 4) * 0.4, 0.3 + rng.rand(2, 1, 4, 4) * 0.4
    return dict(masks=[np.concatenate([lo, hi]).astype(np.float32),
                       np.concatenate([hi, lo * 0.5]).astype(np.float32)],
                lat=rng.randn(4, 3, 5).astype(np.float32),
                w=rng.randn(5, 6).astype(np.float32),
                noise=rng.randn(4, 1, 3, 6).astype(np.float32))


def path_image(lat, w):
    """The path penalty's generator in the test: tanh(lat @ w) as a
    (B, 1, n_latent, 6) image."""
    return torch.tanh(lat @ w)[:, None]


def run_batch_stats(rank, out):
    """At this rank's rows: the minibatch stddev layer's map and its input
    gradient (of sum(map * w)) for each global batch; the mask loss and its
    gradients at the rows; the path-length penalty, its mean and its weight
    gradient averaged over the ranks."""
    from vtoonify_tpu_torch.models.generator import minibatch_stddev
    from vtoonify_tpu_torch.train.losses import g_path_regularize, mask_loss

    for b in STDDEV_BATCHES:
        x, w = (C.local_rows(torch.from_numpy(a)) for a in stddev_inputs(b))
        x = x.clone().requires_grad_()
        y = minibatch_stddev(x)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        out[f"y{b}"], out[f"g{b}"] = y.detach().numpy(), g.numpy()
    inp = loss_inputs()
    masks = [C.local_rows(torch.from_numpy(m)).clone().requires_grad_()
             for m in inp["masks"]]
    loss = mask_loss(masks, MASK_D_S, 1.0)
    out["mask_loss"] = loss.detach().numpy()
    for i, g in enumerate(torch.autograd.grad(loss, masks)):
        out[f"mask_grad{i}"] = g.numpy()
    w = torch.from_numpy(inp["w"]).requires_grad_()
    penalty, mean, lengths = g_path_regularize(
        lambda lat: path_image(lat, w), C.local_rows(torch.from_numpy(inp["lat"])),
        0.5, noise=C.local_rows(torch.from_numpy(inp["noise"])))
    (gw,) = C.gather_grad(torch.autograd.grad(penalty, [w]))
    out.update(path_penalty=C.reduce_sum(penalty.detach()).numpy() / C.get_world_size(),
               path_mean=mean.numpy(), path_lengths=lengths.detach().numpy(),
               path_grad_w=gw.numpy())


def step_setup(backbone, batch=STEP_BATCH):
    """The trainers' --tiny stage-2 configuration, random weights, noise
    weights and biases non-zero (as chip_smoke.py's tiny steps)."""
    import chip_smoke
    from vtoonify_tpu_torch.models.generator import init_generator
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.train import steps as S

    g = torch.Generator().manual_seed(7)
    cfg = VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,
                         num_res_layers=2, backbone=backbone)
    d_style = dict(use_condition=True, style_num=4) if backbone == "dualstylegan" else {}
    dcfg = CondDiscriminatorConfig(size=64, channel_multiplier=1, **d_style)
    tcfg = S.TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40)
    pcfg, mods, inputs = chip_smoke.train_setup(cfg, dcfg, tcfg, batch, g)
    mods["base"] = init_generator(cfg.generator, g)
    with torch.no_grad():
        vt_gen = mods["vt"].generator
        for gen in (mods["base"], getattr(vt_gen, "generator", vt_gen)):
            for blk in [gen.conv1, *gen.convs]:
                blk.noise.weight.fill_(0.1)
                blk.act_bias.normal_(0.0, 0.3, generator=g)
    return cfg, dcfg, tcfg, pcfg, mods, inputs


def _flat(module):
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()]).numpy()


def _grads(opt, module):
    """Adam's first moment over 1 - beta1 after the first step: the gradient
    the step applied (the mean over the ranks under a process group)."""
    from vtoonify_tpu_torch.train.steps import ADAM_BETA1

    return torch.cat([opt.state[p]["exp_avg"].reshape(-1)
                      for p in module.parameters()]).numpy() / (1 - ADAM_BETA1)


def run_steps(rank, out, steps, batch=STEP_BATCH, float64=False):
    """The --tiny D stage-2 step and / or the --tiny T stage-2 step at
    global batch `batch`: this rank's rows, draws of the global batch from
    one seed; the new parameters, the gradients the optimizers applied,
    the EMA and the metrics. `float64` runs the step in float64."""
    from vtoonify_tpu_torch.train import steps as S

    for which in steps:
        backbone = "dualstylegan" if which == "d" else "toonify"
        cfg, dcfg, tcfg, pcfg, m, inputs = step_setup(backbone, batch)
        if float64:
            m = {k: v.double() for k, v in m.items()}
            inputs = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                      for k, v in inputs.items()}
        gen = torch.Generator().manual_seed(11)
        _, frozen = S.split_trainable(m["vt"])
        if which == "d":
            style = C.local_rows(inputs["style"])
            state = S.init_train_d_state(m["vt"], m["d"], len(style), cfg, tcfg,
                                         device="cpu")
            metrics = S.train_d_step(
                state, frozen, m["parsing"], m["psp"], pcfg, None, m["lpips"], cfg,
                dcfg, tcfg, inputs["directions"], style,
                C.local_rows(inputs["style_ind"]), 1.0, inputs["weights"], 0.3, 0.5,
                False, generator=gen)
        else:
            state = S.init_train_t_state(m["vt"], m["d"], tcfg, device="cpu")
            metrics = S.train_t_step(
                state, frozen, m["base"], m["parsing"], m["psp"], pcfg, None,
                m["lpips"], cfg, dcfg, tcfg, inputs["directions"], batch, 0.3,
                generator=gen)
        out.update({f"{which}_metric_{k}": v.numpy() for k, v in metrics.items()})
        for part in ("trainable", "d", "ema"):
            out[f"{which}_{part}"] = _flat(getattr(state, part))
        out[f"{which}_grad_trainable"] = _grads(state.g_opt, state.trainable)
        out[f"{which}_grad_d"] = _grads(state.d_opt, state.d)


@contextlib.contextmanager
def _float64():
    """A CPU diagnostic: the D step in float64 throughout. The kernels'
    plain versions hold operands to the card's float32 / bfloat16 rule, the
    loss arithmetic and the synthesised data are cast to float32, and the
    warp's coordinates are float32; here each of them keeps float64."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.train import augment as A

    def matrix(rows, device=None):
        return torch.tensor(rows, dtype=torch.float64, device=device)

    to_float = torch.Tensor.float
    saved = (K._DTYPE_CODE, K._depth_to_space2_args, K._affine_warp_args,
             A._scale_single, A._translate_single)
    torch.set_default_dtype(torch.float64)
    K._DTYPE_CODE = {**K._DTYPE_CODE, torch.float64: -1}
    K._depth_to_space2_args = K._affine_warp_args = lambda *a: None
    A._scale_single = lambda sx, sy, device=None: matrix(
        [[sx, 0, 0], [0, sy, 0], [0, 0, 1]], device)
    A._translate_single = lambda tx, ty, device=None: matrix(
        [[1, 0, tx], [0, 1, ty], [0, 0, 1]], device)
    torch.Tensor.float = lambda t, *a, **kw: (t if t.dtype == torch.float64
                                              else to_float(t, *a, **kw))
    try:
        yield
    finally:
        torch.Tensor.float = to_float
        (K._DTYPE_CODE, K._depth_to_space2_args, K._affine_warp_args,
         A._scale_single, A._translate_single) = saved
        torch.set_default_dtype(torch.float32)


def run_witness(rank, out, float64=False, rows=False):
    """The --tiny D step at global batch 2 (one row a rank over 2 ranks);
    `rows`: its teacher synthesis a row at a time; `float64`: in float64."""
    import chip_smoke

    with contextlib.ExitStack() as stack:
        if float64:
            stack.enter_context(_float64())
        if rows:
            stack.enter_context(chip_smoke.synthesis_row_by_row())
        run_steps(rank, out, ("d",), batch=2, float64=float64)


CASES = {"collectives": run_collectives, "batch_stats": run_batch_stats,
         "steps_d": lambda r, o: run_steps(r, o, ("d",)),
         "steps_t": lambda r, o: run_steps(r, o, ("t",)),
         "witness_f32": run_witness,
         "witness_f64": lambda r, o: run_witness(r, o, float64=True),
         "witness_rows": lambda r, o: run_witness(r, o, rows=True)}


def witness(out_dir):
    """Runs the witness cases (2 ranks and one process in float32 and in
    float64; one process with the synthesis a row at a time) and prints the
    relative L2 of the gradients, the new parameters and the metrics of
    each pair."""
    import socket

    def port():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    argvs = []
    for case in ("witness_f32", "witness_f64"):
        p = port()
        argvs += [[case, str(r), "2", str(p), f"{out_dir}/two"] for r in range(2)]
        argvs.append([case, "0", "1", "0", f"{out_dir}/one"])
    argvs.append(["witness_rows", "0", "1", "0", f"{out_dir}/one"])
    for d in ("two", "one"):
        os.makedirs(f"{out_dir}/{d}", exist_ok=True)
    procs = [subprocess.Popen([sys.executable, __file__, *a]) for a in argvs]
    try:
        for p in procs:
            if p.wait(timeout=1200):
                raise SystemExit(f"a witness process failed (rc {p.returncode})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    def load(where, case):
        return dict(np.load(f"{out_dir}/{where}/{case}_0.npz"))

    def rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))

    def gaps(got, ref):
        metrics = sorted(k for k in ref if "_metric_" in k)
        return {"metrics": rel(np.array([got[k] for k in metrics]),
                               np.array([ref[k] for k in metrics])),
                **{k[2:]: rel(got[k], ref[k]) for k in ref if "_metric_" not in k}}

    print(json.dumps({
        "two_ranks_vs_one_float32": gaps(load("two", "witness_f32"), load("one", "witness_f32")),
        "two_ranks_vs_one_float64": gaps(load("two", "witness_f64"), load("one", "witness_f64")),
        "rows_vs_one_float32": gaps(load("one", "witness_rows"), load("one", "witness_f32")),
        "two_ranks_vs_rows_float32": gaps(load("two", "witness_f32"),
                                          load("one", "witness_rows"))}))


def main(case, rank, world, port, out_dir):
    torch.set_num_threads(1)
    if world > 1:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    out = {}
    try:
        CASES[case](rank, out)
    finally:
        multihost.shutdown()
    if rank == 0 or not case.startswith("witness"):  # the ranks' are equal
        np.savez(f"{out_dir}/{case}_{rank}.npz", **out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if sys.argv[1] == "witness":
        witness(sys.argv[2])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
