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


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_has_its_family_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((manifest.ROOT / entry["file"]).read_text())
    name = data.get("family", manifest.DEFAULT_FAMILY)
    assert (manifest.BENCH_DIR / "families" / f"{name}.py").is_file()
    module = manifest.family(manifest.Cell("c", 1, data, {}, {}, [], []))
    for fn in ("draw_weights", "build_program", "make_inputs", "output_numbers",
               "control_numbers", "stderr_lines"):
        assert callable(getattr(module, fn)), fn


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (manifest.BENCH_DIR / "traffic")
                                           .glob("*.json")))
def test_every_traffic_has_its_driver_file(traffic):
    data = json.loads((manifest.BENCH_DIR / "traffic" / f"{traffic}.json").read_text())
    assert (manifest.BENCH_DIR / "drivers" / f"{data['driver']}.py").is_file()
    module = manifest.driver(manifest.Cell("c", 1, {}, data, {}, [], []))
    assert callable(module.batch) and callable(module.drive)


def test_a_missing_family_or_driver_is_named():
    cell = manifest.Cell("c", 1, {"family": "no-such-family"}, {"driver": "no-such-driver"},
                         {}, [], [])
    with pytest.raises(FileNotFoundError, match="families/no-such-family.py"):
        manifest.family(cell)
    with pytest.raises(FileNotFoundError, match="drivers/no-such-driver.py"):
        manifest.driver(cell)


# What belongs to the vtoonify family and its drivers: its modules under
# gpubench/, the program, and the words its code is written in.
FAMILY_MODULES = ("gpubench.reference", "gpubench.weights", "gpubench.inputs", "gpubench.work",
                  "vtoonify_tpu_torch")
FAMILY_WORDS = ("toonify", "bisenet", "modconv", "style", "frame_image", "frame_numbers",
                "reference_numbers", "engine", "pipeline", "pool", "b1")


@pytest.mark.parametrize("script", ["run.py", "control.py", "window.py"])
def test_harness_names_no_vtoonify_module_or_function(script):
    """run.py, control.py and window.py import no module of the vtoonify family or of
    the program, and no name in their code (imports, names, attributes,
    definitions, arguments) is one of the family's."""
    import ast

    tree = ast.parse((manifest.BENCH_DIR / script).read_text())
    imported, names = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported += [f"{node.module}.{a.name}" for a in node.names] + [node.module]
        elif isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.arg):
            names.append(node.arg)
    bad = [m for m in imported if m.startswith(FAMILY_MODULES)]
    bad += [n for n in names if any(w in n.lower() for w in FAMILY_WORDS)]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(str(p.relative_to(manifest.BENCH_DIR)) for kind in
                                        ("families", "drivers")
                                        for p in (manifest.BENCH_DIR / kind).glob("*.py")))
def test_families_and_drivers_do_not_import_run(path):
    """A family or driver takes the window's helpers from gpubench.window:
    importing gpubench.run from one would close a cycle through manifest."""
    import ast

    tree = ast.parse((manifest.BENCH_DIR / path).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported += [f"{node.module}.{a.name}" for a in node.names] + [node.module]
    assert "gpubench.run" not in imported, path
