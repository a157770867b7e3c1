"""What the two trainer CLIs (cli/train_d.py, cli/train_t.py) share: the
options both take, the start-up (device, process group, precision, the
options of the JAX trainers that are not ported), the iteration loop with
its logging, preemption guard and profiling window, and the checkpoint
names.

Data parallelism: one process per card, started by `torchrun
--nproc_per_node=N` (detected from its environment) or by hand with
`--multihost --coordinator HOST:PORT --num_processes N --process_id R`
(`parallel/multihost.py`). `--batch` is the global batch; each rank trains
on its share and only rank 0 writes checkpoints, logs and sample grids.

Tensor parallelism (`--tp k`): each rank holds the wide weights of the trees
the JAX trainers split (`tp_row`, `parallel.tensor.shard_module`) over its
own row of k cards, cuda:LOCAL_RANK * k to + k - 1 (with --cpu, the CPU k
times); across ranks the job stays data-parallel. A rank whose row is not
all visible is refused."""

from __future__ import annotations

import os
import time

import torch

from vtoonify_tpu_torch import resolve_device
from vtoonify_tpu_torch.parallel import collectives as C
from vtoonify_tpu_torch.parallel import multihost
from vtoonify_tpu_torch.parallel.mesh import batch_not_divisible
from vtoonify_tpu_torch.train.guards import (
    PreemptionGuard,
    check_finite_metrics,
    enable_nan_debugging,
    handle_preemption,
)
from vtoonify_tpu_torch.train.logging import MetricsLogger
from vtoonify_tpu_torch.utils.checkpoint import save_train_state
from vtoonify_tpu_torch.utils.profiling import StepTrace

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
TINY_TCFG = dict(crop_size=96, lpips_size=64, aug_max_pad=40)


def add_common_args(p, ref: str):
    """The options both trainers take (`ref` names the reference script
    for the help texts)."""
    p.add_argument("--iter", type=int, default=2000)
    p.add_argument("--batch", type=int, default=8,
                   help="global batch size (split over the ranks)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--start_iter", type=int, default=0)
    p.add_argument("--save_every", type=int, default=30000)
    p.add_argument("--save_begin", type=int, default=30000)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--adv_loss", type=float, default=0.01)
    p.add_argument("--grec_loss", type=float, default=0.1)
    p.add_argument("--perc_loss", type=float, default=0.01)
    p.add_argument("--tmp_loss", type=float, default=1.0)
    p.add_argument("--encoder_path", type=str, default=None)
    p.add_argument("--direction_path", type=str,
                   default="./checkpoint/directions.npy")
    p.add_argument("--faceparsing_path", type=str,
                   default="./checkpoint/faceparsing.pth")
    p.add_argument("--style_encoder_path", type=str,
                   default="./checkpoint/encoder.pt")
    p.add_argument("--vgg_path", type=str, default=None,
                   help="torchvision vgg16 state_dict for LPIPS")
    p.add_argument("--lpips_lin_path", type=str, default=None,
                   help="LPIPS lin weights (else $VTOONIFY_LPIPS_LIN)")
    p.add_argument("--allow_random_lpips", action="store_true",
                   help="explicitly allow a randomly-initialized LPIPS net "
                        "when --vgg_path is absent (tests/smoke only — the "
                        "perceptual loss is meaningless with random weights)")
    p.add_argument("--pretrain", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="exact resume from the last full train state "
                        "(params+EMA+optimizers+step)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: the wide weights split over "
                        "this many cards a rank")
    p.add_argument("--multihost", action="store_true",
                   help="join a job of one process per card "
                        "(parallel/multihost.py; torchrun's environment is "
                        "detected without it)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's rendezvous (with --multihost)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="the job's number of processes (with --multihost)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank (with --multihost)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--local_rank", type=int, default=None,
                   help=f"the card this process takes, as the reference's "
                        f"launcher passes it ({ref}); default LOCAL_RANK")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection: fail at the first "
                        "backward op that makes a NaN (slow, debug only)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N steps with torch.profiler (a Chrome trace "
                        "under log/NAME/trace)")
    p.add_argument("--tiny", action="store_true",
                   help="32->128 debug model config (smoke tests only; "
                        "checkpoints must match)")
    p.add_argument("--export_pt", action="store_true",
                   help="also save reference-format torch .pt checkpoints "
                        "(loadable by the reference style_transfer.py and "
                        "by the port's load_reference_vtoonify)")
    p.add_argument("--bf16", action="store_true",
                   help="run the student/D/LPIPS forwards AND the frozen-"
                        "teacher data synthesis in bfloat16 (float32 master "
                        "weights, optimizer state and loss arithmetic)")
    p.add_argument("--synth_fp32", action="store_true",
                   help="with --bf16: keep the frozen-teacher data synthesis "
                        "in float32")
    p.add_argument("--matmul_precision", type=str, default=None,
                   choices=["default", "high", "highest"],
                   help="float32 convs and matmuls on the card: 'highest' "
                        "turns TF32 off, 'high' on; 'default' is torch's")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card; fails without one)")


def start(args) -> torch.device:
    """Print the options, join the job's process group (--multihost, or a
    launcher's environment), check that the rank's --tp cards are visible
    and that the ranks split --batch evenly, set the float32 precision and
    NaN debugging; returns the run's device (the first of the rank's
    row)."""
    if args.encoder_path is None:
        args.encoder_path = os.path.join("./checkpoint/", args.name,
                                         "pretrain.ckpt")
    if args.tp < 1:
        raise SystemExit(f"error: --tp {args.tp} is not a width")
    want = "cpu" if args.cpu else None
    if args.multihost or multihost.launched():
        device = multihost.initialize(args.coordinator, args.num_processes,
                                      args.process_id, args.local_rank, want,
                                      tp=args.tp)
    else:
        device = resolve_device(want)
        if device.type == "cuda" and args.local_rank is not None:
            device = torch.device("cuda", args.local_rank * args.tp)
    tp_row(args, device)
    if is_main():
        print("Load options")
        for k, v in sorted(vars(args).items()):
            print(f"{k}: {v}")
    if args.batch % C.get_world_size():
        raise SystemExit("error: --" + batch_not_divisible(
            args.batch, C.get_world_size(), "world size"))
    if args.matmul_precision is not None:
        from vtoonify_tpu_torch.cli.style_transfer import set_float32_precision

        set_float32_precision(args.matmul_precision)
    if args.debug_nans:
        enable_nan_debugging()
    if is_main():
        os.makedirs(f"checkpoint/{args.name}", exist_ok=True)
    return device


def tp_row(args, device) -> list:
    """The devices this rank splits its wide weights over (--tp of them,
    the first being `device`): consecutive cards, or the CPU --tp times.
    Raises SystemExit when the row's last card is not visible."""
    if device.type != "cuda":
        return [device] * args.tp
    first = device.index or 0
    visible = torch.cuda.device_count()
    if first + args.tp > visible:
        raise SystemExit(
            f"error: --tp {args.tp} on rank {C.get_rank()} of {C.get_world_size()} "
            f"needs cards cuda:{first}-{first + args.tp - 1} "
            f"({C.get_world_size() * args.tp} for the job); {visible} visible")
    return [torch.device("cuda", first + j) for j in range(args.tp)]


def shard(args, device, *modules) -> None:
    """With --tp > 1, each module's wide weights split over this rank's row
    (`parallel.tensor.shard_module`, JAX's rule), in place."""
    if args.tp > 1:
        from vtoonify_tpu_torch.parallel.tensor import shard_module

        row = tp_row(args, device)
        for m in modules:
            shard_module(m, row)


def is_main() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return C.get_rank() == 0


def local_batch(args) -> int:
    """This rank's share of --batch."""
    return args.batch // C.get_world_size()


def precision(args) -> dict:
    """The steps' compute_dtype / synth_dtype from --bf16 / --synth_fp32."""
    return dict(compute_dtype="bfloat16" if args.bf16 else None,
                synth_dtype="float32" if args.synth_fp32 else None)


def checkpoint_name(args, idx: int, final: str, every: str):
    """The name of the checkpoint saved after iteration `idx`, or None when
    none is due: `final` after the last iteration, `every` (formatted with
    the iteration count) at the save cadence."""
    n = idx + 1
    if n == args.iter:
        return final
    if n >= args.save_begin and n % args.save_every == 0:
        return every.format(n)
    return None


def train_loop(args, state, state_path: str, step, save, log_grid=None):
    """Iterations start_iter .. iter - 1: `step(idx)` runs one and returns
    (metrics, extra log fields), then a metrics line every log_every // 10
    iterations (non-finite metrics raise), `log_grid(idx)`, on SIGTERM the
    full state saved to `state_path` and a clean return, else `save(idx)`;
    and the --profile window. Under a process group every rank steps and
    checks its metrics; rank 0 alone logs, traces and saves; the group is
    left at the end."""
    main = is_main()
    log_dir = f"log/{args.name}"
    mlog = MetricsLogger(log_dir) if main else None
    profile = args.profile if main else 0
    tracer = StepTrace(os.path.join(log_dir, "trace"), args.start_iter + 1, profile)
    guard = PreemptionGuard()
    save_state = ((lambda: save_train_state(state_path, state)) if main
                  else (lambda: None))
    t0 = time.time()
    try:
        for idx in range(args.start_iter, args.iter):
            if profile:
                tracer.before(idx)
            metrics, extra = step(idx)
            if profile:
                tracer.after(idx)
            if (idx + 1) % max(args.log_every // 10, 1) == 0:
                check_finite_metrics(metrics, idx)
                if main:
                    mlog.log(idx, metrics, **extra)
                    m = {k: f"{float(v):.4f}" for k, v in metrics.items()}
                    print(f"iter {idx}: {m} ({(time.time() - t0) / (idx - args.start_iter + 1):.2f}"
                          " s/it)", flush=True)
            if main and log_grid is not None:
                log_grid(idx)
            if handle_preemption(guard, save_state, idx + 1):
                return
            if main:
                save(idx)
    finally:
        tracer.close()
        guard.uninstall()
        multihost.shutdown()
