"""Run one cell of the benchmark once and print its result.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (BENCHMARK.json "workloads") names a configuration
(gpubench/configs/) and a traffic mix (gpubench/traffic/). The
configuration's family (gpubench/families/) draws the weights from the seed
on the first card, builds the program through its own loaders and entry
points, and makes the run's inputs from the seed. The traffic's driver
(gpubench/drivers/) warms up the cell's shapes and drives the program
through the window. Set-up ends where the window starts.

With --trace 0 the result carries the cell's end-to-end metrics, taken by
the host clock; with --trace 1 the window runs under torch.profiler and the
result carries the per-layer metrics (gpubench/metrics/), the device's busy
and window seconds and a breakdown. After the window, a seeded sample of the
outputs the window produced is held by the family to its plain reference at
the same sizes; the numbers compared and their limits
(gpubench/limits/<cell>.json) are the last lines on standard error and the
last key of the result, the last line on standard output.

Exits with 2 and no result without enough CUDA cards, with 3 if JAX or the
JAX package was imported. Kernel build and compile caches stay in
.gpubench_cache/ and the program's own build directory, both in the
checkout.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

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

from gpubench.window import T_START, sync  # noqa: E402  (the set-up clock starts here)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import time  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench import manifest, seeds  # noqa: E402
from gpubench.trace import Trace  # noqa: E402


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
    """One reservoir per card's share of a batch (output k of a batch of B
    lies on dp row (k % B) // (B / dp)), so the sample holds outputs from
    every card."""

    def __init__(self, k: int, dp: int, batch: int, seed: int):
        rng = random.Random(seeds.derive_seed(seed, seeds.STREAM_SAMPLE))
        self.batch, self.dp = batch, dp
        self.parts = [Reservoir(max(1, math.ceil(k / dp)), rng) for _ in range(dp)]

    def offer(self, index, key, make):
        row = (index % self.batch) // max(1, self.batch // self.dp)
        self.parts[min(row, self.dp - 1)].offer(key, make)

    @property
    def items(self):
        return [it for p in self.parts for it in p.items]


def judge(numbers: list, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): the worst sampled output's reading
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
    tr = cell.traffic
    if tr["dp"] != cell.chips:
        raise ValueError(f"traffic dp {tr['dp']} != the cell's chips {cell.chips}")
    family, driver = manifest.family(cell), manifest.driver(cell)
    if devices is None:
        devices = [f"cuda:{i}" for i in range(cell.chips)]
    first = torch.device(devices[0])
    cards = [torch.device(d).index or 0 for d in devices] if first.type == "cuda" else []
    phases = {"imports": time.perf_counter() - T_START}
    t = time.perf_counter()
    state = family.draw_weights(cell.config, seed, first)
    sync(cards)
    phases["weights"], t = time.perf_counter() - t, time.perf_counter()
    program = family.build_program(cell.config, tr, state, first, devices, phases)
    del state
    sync(cards)
    phases["program"], t = time.perf_counter() - t, time.perf_counter()
    inputs = family.make_inputs(cell.config, tr, seed, first)
    batch = driver.batch(program, tr)
    run = Run(cell.name, cell.config, tr, batch, cards or [str(first)], seconds, phases=phases)
    phases["inputs"] = time.perf_counter() - t
    sampler = Sampler(tr["check_frames"], tr["dp"], batch, seed)
    driver.drive(run, program, inputs, sampler, trace)

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
            value = manifest.metric_reader(m["name"], cell.bench_dir)(run)
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
    del program, inputs
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = family.output_numbers(cell.config, tr, seed, samples, first)
    run.phases["check"] = time.perf_counter() - t
    print(f"gpubench: phases {json.dumps(run.phases)}", file=sys.stderr)
    if run.stages:
        print(f"gpubench: engine stages {json.dumps(run.stages)}", file=sys.stderr)
    if run.latencies_s:
        print(f"gpubench: request ms {json.dumps(_quantiles(run))}", file=sys.stderr)
    for line in family.stderr_lines(run):
        print(f"gpubench: {line}", file=sys.stderr)
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
