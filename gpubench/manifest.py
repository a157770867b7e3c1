"""Find a cell, its configuration, its traffic, its limits and its metrics
by name, from `BENCHMARK.json` and the files under `gpubench/`.

    gpubench/configs/<config>.json     a configuration (BENCHMARK.json "file")
    gpubench/traffic/<traffic>.json    a traffic mix, read by run.py's drivers
    gpubench/limits/<workload>.json    the limits of the cell's output check
    gpubench/metrics/<metric>.py       a per-layer metric's reader, read(run)

Adding a cell, a configuration or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


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


def _reported(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, chips=w["chips"],
        config=_read(root / configs[w["config"]]["file"]),
        traffic=_read(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_read(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)])


def metric_reader(metric: str):
    """The `read(run)` function of gpubench/metrics/<metric>.py."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
