"""Find a cell, its configuration, its traffic, its limits, its family, its
driver and its metrics by name, from `BENCHMARK.json` and the files under
`gpubench/`.

    gpubench/configs/<config>.json     a configuration (BENCHMARK.json "file");
                                       its "family" key names its family
                                       (none: "vtoonify")
    gpubench/traffic/<traffic>.json    a traffic mix; its "driver" key names
                                       its driver
    gpubench/limits/<workload>.json    the limits of the cell's output check
    gpubench/families/<family>.py      a model family (below)
    gpubench/drivers/<driver>.py       a traffic loop (below)
    gpubench/metrics/<metric>.py       a per-layer metric's reader, read(run)

Adding a cell, a configuration, a family, a driver or a metric adds files
and entries; no file here changes.

A family module provides, each taking the configuration and traffic as
read from their files:

    draw_weights(config, seed, device) -> state
        the weights, drawn from the seed on `device` (the first card)
    build_program(config, traffic, state, device, devices, phases) -> program
        the system under test, built through the program's own loaders and
        entry points, on `device` or over `devices`; it may record set-up
        seconds by step in `phases`
    make_inputs(config, traffic, seed, device) -> inputs
        the run's inputs, drawn from the seed, in the form its traffic's
        driver takes them
    output_numbers(config, traffic, seed, samples, device) -> [dict]
        per sampled output (the (input key, output) pairs the driver offered
        the run's `Sampler`), the numbers that `limits/<cell>.json` may name,
        against the family's plain reference computed again from the seed
        on `device`, in blocks
    control_numbers(config, traffic, seed, device) -> [dict]
        the same numbers of the control: the reference in the nearest
        precision below the configuration's, in the program's place
    stderr_lines(run) -> [str]
        lines for standard error about the finished run (may be none)

A driver module provides:

    batch(program, traffic) -> int
        the outputs a dispatch carries, over all cards
    drive(run, program, inputs, sampler, trace)
        warms up the cell's shapes, records "warmup" in `run.phases`, then
        runs the window through `gpubench.window.windowed`: it sets
        `run.setup_s` as the window opens (from `gpubench.window.T_START`)
        and fills the `Run`'s `attempted`, `done_in_window`, `frames_traced`,
        `card_batches_traced`, and where it has them `stages` and, one each a
        request, `latencies_s` and `dispatch_s`; it offers each output
        finished in the window to `sampler`

Drivers take the window's clock, spans, card sync and tracing from
`gpubench/window.py`; neither a family nor a driver imports `gpubench.run`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
DEFAULT_FAMILY = "vtoonify"  # of a configuration without a "family" key


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    bench_dir: Path = BENCH_DIR  # where its family, driver and metric files are found


def _reported(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json, its files under
    `root`/gpubench."""
    bench = _read(root / "BENCHMARK.json")
    bench_dir = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, chips=w["chips"],
        config=_read(root / configs[w["config"]]["file"]),
        traffic=_read(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_read(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
        bench_dir=bench_dir)


def _module(bench_dir: Path, kind: str, name: str):
    """gpubench/<kind>/<name>.py, loaded from its file."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind[:-1]} {name!r} not found: no file {path}")
    spec = importlib.util.spec_from_file_location(f"gpubench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(cell: Cell):
    """The module gpubench/families/<family>.py of the cell's configuration."""
    return _module(cell.bench_dir, "families", cell.config.get("family", DEFAULT_FAMILY))


def driver(cell: Cell):
    """The module gpubench/drivers/<driver>.py of the cell's traffic."""
    return _module(cell.bench_dir, "drivers", cell.traffic["driver"])


def metric_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The `read(run)` function of gpubench/metrics/<metric>.py."""
    return _module(bench_dir, "metrics", metric).read
