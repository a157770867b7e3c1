"""BENCHMARK.json against the contract it is held to, and the loader that
finds each cell's configuration, traffic, limits and metric readers by name."""

import json
import re

import pytest

from gpubench import manifest

BENCH = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"][1].startswith("gpubench/")


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = manifest.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert cell.traffic["dp"] == cell.chips
    assert cell.limits["limits"]
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(manifest.metric_reader(m["name"]))


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_config_used_and_found():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and c["reduced"] == data["reduced"] == []


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.load_cell("no-such-cell")
