"""A run end to end on the CPU at tiny sizes: the weights reach the program
through its own checkpoint loader, the program's frames agree with the plain
reference, the result line has the contract's schema, and the check fails
the control and every fault a cell can have."""

import json
import subprocess
import sys

import pytest
import torch

from gpubench import inputs, manifest, run, weights
from gpubench.tests import tiny

torch.set_num_threads(2)
SEED = 2 ** 31 + 17  # over 32 signed bits, as the driver's are


@pytest.mark.parametrize("backbone", ["dualstylegan", "toonify"])
def test_program_float32_matches_reference(backbone):
    cell = tiny.cell("vtd-video-400x360", backbone=backbone)
    res = run.run_cell(cell, SEED, 3.0, False, devices=["cpu"])
    assert res["correct"]
    assert res["readings"]["max_lsb"] <= 1 and res["readings"]["mean_lsb"] < 1e-3


def _schema(res, trace):
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "check"
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] is not None
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.parametrize("like,trace", [("vtd-video-400x360", False),
                                        ("vtd-video-400x360", True),
                                        ("vtd-image-1024", False),
                                        ("vtd-image-1024", True)])
def test_result_schema(like, trace):
    cell = tiny.cell(like)
    res = run.run_cell(cell, SEED, 2.0, trace, devices=["cpu"])
    _schema(res, trace)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:  # no card: the device readers find nothing, the host ones read
        assert {n for n in res["metrics"]} >= {n for n in names if n.startswith(("dispatch",
                                                                                 "mfu"))}
    else:
        assert set(res["metrics"]) == names and all(m["value"] > 0 for m in res["metrics"].values())


def test_frames_from_every_replica_are_checked():
    sampler = run.Sampler(8, 4, 64, SEED)
    for k in range(640):
        sampler.offer(k, k, lambda: None)
    rows = sorted({(k % 64) // 16 for k, _ in sampler.items})
    assert rows == [0, 1, 2, 3] and len(sampler.items) == 8


@pytest.mark.parametrize("like,backbone", [("vtd-video-400x360", "dualstylegan"),
                                           ("vtt-video-400x360", "toonify"),
                                           ("vtd-image-1024", "dualstylegan"),
                                           ("vtd-video-400x360-dp4", "dualstylegan")])
def test_control_is_not_correct(like, backbone):
    """The float8 control in the program's place fails the cell's limits."""
    cell = tiny.cell(like, backbone=backbone)
    nums = manifest.family(cell).control_numbers(cell.config, cell.traffic, SEED, "cpu")
    assert len(nums) == cell.traffic["check_frames"]
    assert not run.judge(nums, cell.limits)[0]


def _faulty(monkeypatch, fault):
    from vtoonify_tpu_torch.pipeline import toonify

    if fault == "answer_altered":  # each frame leaves with its neighbour's answer
        orig = toonify._quantize
        monkeypatch.setattr(toonify, "_quantize", lambda y, packed=False: torch.roll(
            orig(y, packed), 1, dims=0))
    elif fault == "answer_offset":  # every value twelve steps up, where it is made
        orig = toonify._quantize
        monkeypatch.setattr(toonify, "_quantize", lambda y, packed=False: (
            orig(y, packed).to(torch.int16) + 12).clamp(0, 255).to(torch.uint8))
    elif fault == "exchange_left_out":  # the other replicas' frames never reach card 0
        orig = toonify.ToonifyPipeline._run

        def no_exchange(self, graph, s_w, *batches):
            out = orig(self, graph, s_w, *batches).clone()
            out[out.shape[0] // len(self._replicas):] = 0
            return out
        monkeypatch.setattr(toonify.ToonifyPipeline, "_run", no_exchange)


@pytest.mark.parametrize("fault,like,dp", [
    (None, "vtd-video-400x360", 2),
    ("answer_altered", "vtd-video-400x360", 1),
    ("answer_offset", "vtd-image-1024", 1),
    ("exchange_left_out", "vtd-video-400x360", 2),
    (None, "vtd-video-400x360-dp4", 4),
    ("answer_altered", "vtd-video-400x360-dp4", 4),
    ("exchange_left_out", "vtd-video-400x360-dp4", 4)])
def test_fault_makes_the_run_not_correct(monkeypatch, fault, like, dp):
    """The whole run past the look for a card, with the timed path broken
    underneath: `correct` comes out false (and true without a fault)."""
    cell = tiny.cell(like, dp=dp)
    if cell.traffic["driver"] == "engine":
        cell.traffic["batch"] = 4 * max(1, dp // 2)  # two frames a device from dp 2 up
    _faulty(monkeypatch, fault)
    res = run.run_cell(cell, SEED, 3.0, False, devices=["cpu"] * dp)
    assert res["correct"] is (fault is None)


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "vtd-video-400x360", "--seed", "1", "--seconds", "1"])
    assert e.value.code == 2


def test_same_seed_same_inputs():
    a = inputs.frame_pool(SEED, 3, 8, 16, "cpu")
    assert torch.equal(a, inputs.frame_pool(SEED, 3, 8, 16, "cpu"))
    assert not torch.equal(a, inputs.frame_pool(SEED + 1, 3, 8, 16, "cpu"))
    layout = weights.bisenet_layout({"n_classes": 19})
    s1 = weights.make_state(layout, SEED, "cpu")
    s2 = weights.make_state(layout, SEED, "cpu")
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_imports_no_jax_and_reference_no_program():
    """Every gpubench module imported in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or vtoonify_tpu (vtoonify_tpu_torch
    is another name); the reference alone imports nothing of the program."""
    code = (
        "import sys, importlib, pkgutil, gpubench\n"
        "import gpubench.reference\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'vtoonify_tpu_torch' not in tops, 'reference imports the program'\n"
        "for m in pkgutil.walk_packages(gpubench.__path__, 'gpubench.'):\n"
        "    importlib.import_module(m.name)\n"
        "from gpubench import manifest, run\n"
        "cell = manifest.load_cell('vtd-video-400x360')\n"
        "manifest.family(cell), manifest.driver(cell)  # the program loads where a run needs it\n"
        "import vtoonify_tpu_torch.pipeline.toonify, vtoonify_tpu_torch.pipeline.video\n"
        "import vtoonify_tpu_torch.utils.checkpoint, vtoonify_tpu_torch.parallel.mesh\n"
        "for name in ('dispatch_ms.video', 'mfu.image'):\n"
        "    manifest.metric_reader(name)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & set(run.FORBIDDEN))\n"
        "assert not bad, bad\n"
        "assert run.forbidden_modules() == []\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card (the chip's command)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    res = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "vtd-video-400x360",
                          "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
