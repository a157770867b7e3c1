"""Run one cell of the benchmark once and print its result.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (BENCHMARK.json "workloads") names a configuration
(gpubench/configs/) and a traffic mix (gpubench/traffic/). From the seed the
run draws, on the first card, the weights in the upstream checkpoint layout
(gpubench/weights.py), the frame pool and the style code
(gpubench/inputs.py). The program, vtoonify_tpu_torch, loads the weights
through its own checkpoint loader and serves the traffic: the "engine"
driver runs its video engine (`toonify_frames`) in a closed loop over the
pool until the window closes; the "frame" driver sends one frame at a time
through `ToonifyPipeline.process_batch` and fetches it before the next.
Set-up (load, warm-up of the cell's shapes) ends where the window starts.

With --trace 0 the result carries the cell's end-to-end metrics, taken by
the host clock; with --trace 1 the window runs under torch.profiler and the
result carries the per-layer metrics (gpubench/metrics/), the device's busy
and window seconds and a breakdown. After the window, a seeded sample of the
frames the window produced is held to the plain reference
(gpubench/reference.py) at the same sizes; the numbers compared and their
limits (gpubench/limits/<cell>.json) are the last lines on standard error
and the last key of the result, the last line on standard output.

Exits with 2 and no result without enough CUDA cards, with 3 if JAX or the
JAX package was imported. Kernel build and compile caches stay in
.gpubench_cache/ and the program's own vtoonify_tpu_torch/_build/, both in
the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".gpubench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "vtoonify_tpu")


def _set_cache_dirs():
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


if __name__ == "__main__":  # before torch is imported; `python3 gpubench/run.py` finds the package
    _set_cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench import inputs, manifest, reference, weights  # noqa: E402
from gpubench.trace import WINDOW, Trace  # noqa: E402

FPS_TAG = 25.0  # the frame rate the engine's writer is opened with; unused


@dataclass
class Run:
    """What a window did, for the metrics and the readers."""
    name: str
    config: dict
    traffic: dict
    batch: int
    cards: list
    seconds: float
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0  # a request that raises ends the run, so none is counted here
    done_in_window: int = 0
    latencies_s: list = field(default_factory=list)
    dispatch_s: list = field(default_factory=list)
    stages: dict = None
    trace: Trace = None
    frames_traced: int = 0
    card_batches_traced: int = 0
    phases: dict = field(default_factory=dict)  # set-up seconds by step, for stderr


class Reservoir:
    """A seeded uniform sample of k of the items offered (algorithm R);
    `make()` is called only for an item that is kept."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, key, make):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((key, make()))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = (key, make())


class Sampler:
    """One reservoir per card's share of a batch (frame k of a batch of B
    lies on dp row (k % B) // (B / dp)), so the sample holds frames from
    every card."""

    def __init__(self, k: int, dp: int, batch: int, seed: int):
        rng = random.Random(weights.derive_seed(seed, inputs.STREAM_SAMPLE))
        self.batch, self.dp = batch, dp
        self.parts = [Reservoir(max(1, math.ceil(k / dp)), rng) for _ in range(dp)]

    def offer(self, index, key, make):
        row = (index % self.batch) // max(1, self.batch // self.dp)
        self.parts[min(row, self.dp - 1)].offer(key, make)

    @property
    def items(self):
        return [it for p in self.parts for it in p.items]


class Collector:
    """The engine's writer: counts every frame, times it, and offers the
    ones written before the window closed to the sampler."""

    def __init__(self, t_end: float, sampler: Sampler, pool_size: int, start_at: int, span=False):
        self.t_end, self.sampler, self.pool, self.start = t_end, sampler, pool_size, start_at
        self.count = self.in_window = 0
        self.span = span

    def write(self, frame):
        t = time.perf_counter()
        k = self.count
        self.count += 1
        if t <= self.t_end:
            self.in_window += 1
            with _span("gpubench.keep", self.span):
                # a view: the fetched batch it lies in stays alive, uncopied
                self.sampler.offer(k, (self.start + k) % self.pool, lambda: frame)

    def close(self):
        return self.count


def _span(name, on):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class _Spanned:
    """The pipeline with each process_batch call inside a host span, for the
    trace's idle-gap labels; every other attribute is the pipeline's."""

    def __init__(self, pipe):
        self._pipe = pipe

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def process_batch(self, *args, **kwargs):
        with torch.profiler.record_function("gpubench.dispatch"):
            return self._pipe.process_batch(*args, **kwargs)


# ---------------------------------------------------------------------------
# drivers


def _frames(pool, start_at, batch, deadline=None, limit=None):
    """(fps, frame) from the pool, cycled; stops at a batch boundary once
    `deadline` has passed, or after `limit` frames."""
    i = 0
    while True:
        if limit is not None and i >= limit:
            return
        if deadline is not None and i % batch == 0 and time.perf_counter() >= deadline:
            return
        yield FPS_TAG, pool[(start_at + i) % len(pool)]
        i += 1


def engine_batch(pipe, traffic) -> int:
    from vtoonify_tpu_torch.pipeline.model_api import dynamic_batch_size

    if traffic["batch"] is not None:
        return traffic["batch"]
    h, w = traffic["frame_hw"]
    return dynamic_batch_size(w, h, on_accelerator=pipe.device.type == "cuda")


def engine_run(run, pipe, pool, s_w, sampler, timer, trace):
    from vtoonify_tpu_torch.pipeline.video import MemoryWriter, toonify_frames

    tr, b = run.traffic, run.batch
    # batch_size None leaves the engine its own choice, which `b` repeats
    t_warm = time.perf_counter()
    opts = dict(style_degree=tr["style_degree"], batch_size=tr["batch"],
                max_in_flight=tr["max_in_flight"],
                s_w=s_w, scale_image=True, landmarker=None)
    toonify_frames(pipe, _frames(pool, 0, b, limit=tr["warmup_batches"] * b),
                   lambda fps, size: MemoryWriter(keep=False), **opts)
    start_at = (tr["warmup_batches"] * b) % len(pool)
    _sync(run.cards)

    def window():
        run.setup_s = time.perf_counter() - T_START
        t0 = time.perf_counter()
        col = Collector(t0 + run.seconds, sampler, len(pool), start_at, span=trace)
        frames = _frames(pool, start_at, b, deadline=t0 + run.seconds)
        toonify_frames(_Spanned(pipe) if trace else pipe, frames, lambda fps, size: col,
                       timer=timer, **opts)
        _sync(run.cards)
        # every frame sent is written, after the window if need be
        run.attempted = run.frames_traced = col.count
        run.done_in_window = col.in_window
        run.card_batches_traced = (col.count // b) * run.traffic["dp"]
    run.phases["warmup"] = time.perf_counter() - t_warm
    _windowed(run, window, trace)
    run.stages = timer.summary()


def frame_run(run, pipe, pool, s_w, sampler, trace):
    tr = run.traffic
    d_s = tr["style_degree"]
    t_warm = time.perf_counter()
    for i in range(tr["warmup_requests"]):
        out = pipe.process_batch(pool[i % len(pool)][None], s_w, d_s).cpu()
    buf = torch.empty(out.shape, dtype=out.dtype)
    buf.copy_(out)
    _sync(run.cards)
    run.phases["warmup"] = time.perf_counter() - t_warm

    def window():
        run.setup_s = time.perf_counter() - T_START
        t_end = time.perf_counter() + run.seconds
        i = 0
        while time.perf_counter() < t_end:
            frame = pool[i % len(pool)][None]
            t_a = time.perf_counter()
            with _span("gpubench.dispatch", trace):
                out = pipe.process_batch(frame, s_w, d_s)
            t_b = time.perf_counter()
            with _span("gpubench.fetch", trace):
                # the client reuses its host buffer: a fresh pageable one a
                # request pays 4-33 ms of first touches, differing by process
                buf.copy_(out)
            t_c = time.perf_counter()
            run.latencies_s.append(t_c - t_a)
            run.dispatch_s.append(t_b - t_a)
            with _span("gpubench.keep", trace):
                sampler.offer(i, i % len(pool), lambda: buf[0].numpy().copy())
            i += 1
        run.attempted = run.done_in_window = run.frames_traced = i
        run.card_batches_traced = i
    _windowed(run, window, trace)


def _windowed(run, window, trace):
    if not trace:
        window()
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            window()
    t = time.perf_counter()
    run.trace = Trace(prof)
    run.phases["trace_reduction"] = time.perf_counter() - t


def _sync(cards):
    for c in cards:
        if isinstance(c, int):
            torch.cuda.synchronize(c)


# ---------------------------------------------------------------------------
# program, check, result


def _as_file(state: dict, key=None) -> io.BytesIO:
    """`state` as a checkpoint file in memory (under `key`, if given)."""
    obj = {k: v.detach().cpu() for k, v in state.items()}
    buf = io.BytesIO()
    torch.save(obj if key is None else {key: obj}, buf)
    buf.seek(0)
    return buf


def build_program(config, traffic, vt_sd, bs_sd, device, devices, phases=None):
    """The program's pipeline, its weights loaded by its own loaders from
    the upstream layout, as a released checkpoint would be."""
    phases = {} if phases is None else phases
    t = time.perf_counter()
    from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
    from vtoonify_tpu_torch.utils.checkpoint import (load_reference_faceparsing,
                                                     load_reference_vtoonify)

    cfg = VToonifyConfig(**config["vtoonify"])
    files = _as_file(vt_sd, "g_ema"), _as_file(bs_sd)
    phases["program.files"], t = time.perf_counter() - t, time.perf_counter()
    vt, _ = load_reference_vtoonify(files[0], cfg)
    parsing = load_reference_faceparsing(files[1])
    phases["program.load"] = time.perf_counter() - t
    dtype = getattr(torch, config["dtype"])
    if traffic["dp"] > 1:
        from vtoonify_tpu_torch.parallel.mesh import make_mesh

        return ToonifyPipeline(vt, cfg, parsing, dtype=dtype, mesh=make_mesh(devices=devices))
    return ToonifyPipeline(vt, cfg, parsing, dtype=dtype, device=device)


def frame_numbers(prog_u8: torch.Tensor, ref_u8: torch.Tensor) -> dict:
    """One frame's gaps to the reference, in uint8 steps (LSB): their mean
    and largest, the 99.9th percentile, the share of values off by more
    than 4 and 8 steps, and the mean as a share of the spread (standard
    deviation) of the reference frame's values."""
    gap = (prog_u8.to(torch.int16) - ref_u8.to(torch.int16)).abs()
    counts = torch.bincount(gap.flatten().to(torch.int64), minlength=256).double()
    n = counts.sum()
    cum = counts.cumsum(0)
    mean = (counts * torch.arange(256, dtype=torch.float64, device=counts.device)).sum() / n
    spread = ref_u8.double().std().clamp(min=1.0)
    return {"gap_pct": 100.0 * (mean / spread).item(), "mean_lsb": mean.item(),
            "max_lsb": float(torch.nonzero(counts).max().item()),
            "p999_lsb": float(torch.searchsorted(cum, 0.999 * n).item()),
            "over4_pct": 100.0 * (1.0 - cum[4] / n).item(),
            "over8_pct": 100.0 * (1.0 - cum[8] / n).item()}


def reference_numbers(config, traffic, seed, samples, device, precision="float32",
                      against=None) -> list:
    """Per sampled frame (pool index, program uint8 (H', W', 3)), the gap of
    the program's frame to the reference's, computed again from the seed on
    `device` in blocks of `check_block` frames. With `against` (a precision)
    the sample's frames are replaced by that precision's reference frames:
    the control."""
    vt_cfg = config["vtoonify"]
    vt_sd = weights.make_state(weights.vtoonify_layout(vt_cfg), seed, device, inputs.STREAM_VT)
    bs_sd = weights.make_state(weights.bisenet_layout(config["bisenet"]), seed, device,
                               inputs.STREAM_BISENET)
    h, w = traffic["frame_hw"]
    pool = inputs.frame_pool(seed, traffic["pool"], h, w, device)
    s_w = inputs.style_code(seed, vt_cfg, device)
    block = traffic.get("check_block", 2)
    out = []
    for at in range(0, len(samples), block):
        part = samples[at:at + block]
        idx = torch.tensor([k for k, _ in part], device=device)
        y = reference.frame_image(vt_sd, bs_sd, vt_cfg, pool[idx], s_w,
                                  traffic["style_degree"], precision)
        ref_u8 = reference.quantize(y)
        del y
        if against is not None:
            got = reference.quantize(reference.frame_image(
                vt_sd, bs_sd, vt_cfg, pool[idx], s_w, traffic["style_degree"], against))
        else:
            got = torch.stack([torch.as_tensor(np.ascontiguousarray(f), device=device)
                               for _, f in part])
        for j in range(len(part)):
            if got[j].shape != ref_u8[j].shape:
                raise ValueError(f"frame shape {tuple(got[j].shape)}, reference "
                                 f"{tuple(ref_u8[j].shape)}")
            out.append(frame_numbers(got[j], ref_u8[j]))
    return out


def judge(numbers: list, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): the worst sampled frame's reading
    of each number the cell's limits name, each held to its limit."""
    check = {}
    for name, limit in limits["limits"].items():
        value = max(n[name] for n in numbers) if numbers else math.inf
        check[name] = {"value": value, "limit": limit}
    ok = bool(numbers) and all(c["value"] <= c["limit"] for c in check.values())
    return ok, check


def _quantiles(run) -> dict:
    """p50, p90, p95, p99 and max of each request's latency, its dispatch
    and its fetch (the rest), in ms."""
    lat = np.asarray(run.latencies_s) * 1e3
    dis = np.asarray(run.dispatch_s) * 1e3
    qs = (50, 90, 95, 99, 100)
    return {name: [float(v) for v in np.percentile(a, qs)]
            for name, a in (("latency", lat), ("dispatch", dis), ("fetch", lat - dis))}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, devices=None) -> dict:
    """One run of `cell`; returns the result object. `devices` (default:
    the first `chips` cards) may name CPU devices, for the tests."""
    from vtoonify_tpu_torch.utils.profiling import StageTimer

    tr = cell.traffic
    if tr["dp"] != cell.chips:
        raise ValueError(f"traffic dp {tr['dp']} != the cell's chips {cell.chips}")
    if devices is None:
        devices = [f"cuda:{i}" for i in range(cell.chips)]
    first = torch.device(devices[0])
    cards = [torch.device(d).index or 0 for d in devices] if first.type == "cuda" else []
    phases = {"imports": time.perf_counter() - T_START}
    t = time.perf_counter()
    vt_sd = weights.make_state(weights.vtoonify_layout(cell.config["vtoonify"]), seed, first,
                               inputs.STREAM_VT)
    bs_sd = weights.make_state(weights.bisenet_layout(cell.config["bisenet"]), seed, first,
                               inputs.STREAM_BISENET)
    _sync(cards)
    phases["weights"], t = time.perf_counter() - t, time.perf_counter()
    pipe = build_program(cell.config, tr, vt_sd, bs_sd, first, devices, phases)
    del vt_sd, bs_sd
    _sync(cards)
    phases["program"], t = time.perf_counter() - t, time.perf_counter()
    h, w = tr["frame_hw"]
    pool = inputs.frame_pool(seed, tr["pool"], h, w, first).cpu().numpy()
    s_w = inputs.style_code(seed, cell.config["vtoonify"], first)
    batch = engine_batch(pipe, tr) if tr["driver"] == "engine" else tr["batch"]
    run = Run(cell.name, cell.config, tr, batch, cards or [str(first)], seconds, phases=phases)
    phases["inputs"] = time.perf_counter() - t
    sampler = Sampler(tr["check_frames"], tr["dp"], batch, seed)
    if tr["driver"] == "engine":
        engine_run(run, pipe, pool, s_w, sampler, StageTimer(), trace)
    else:
        frame_run(run, pipe, pool, s_w, sampler, trace)

    found = forbidden_modules()
    if found:
        print(f"gpubench: the run imported {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
    device = {"platform": "gpu" if cards else "cpu",
              "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
              "count": len(devices),
              "memory_peak_bytes": max((torch.cuda.max_memory_allocated(c) for c in cards),
                                       default=0)}
    extra = {}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = run.trace.mean_busy_s(run.cards) if cards else 0.0
        device["window_s"] = run.trace.window_s
        extra["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps(run.cards[0]) if cards else []}
    else:
        fps = run.done_in_window / seconds
        values = {"setup_s": run.setup_s, "fps": fps,
                  "frame_ms_p95": (1e3 * float(np.percentile(run.latencies_s, 95))
                                   if run.latencies_s else None)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    samples = sampler.items
    del pipe, pool
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = reference_numbers(cell.config, tr, seed, samples, first)
    run.phases["check"] = time.perf_counter() - t
    print(f"gpubench: phases {json.dumps(run.phases)}", file=sys.stderr)
    if run.stages:
        print(f"gpubench: engine stages {json.dumps(run.stages)}", file=sys.stderr)
    if run.latencies_s:
        print(f"gpubench: request ms {json.dumps(_quantiles(run))}", file=sys.stderr)
    if trace and cards:
        b1 = run.trace.op_seconds("modconv3x3")
        print(f"gpubench: traced B1 launches {b1[1]} ({b1[0]} s), card batches "
              f"{run.card_batches_traced}", file=sys.stderr)
    correct, check = judge(numbers, cell.limits)
    readings = {k: max(n[k] for n in numbers) for k in numbers[0]} if numbers else {}
    return {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device, **extra, "readings": readings, "check": check}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        raise SystemExit(2)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
