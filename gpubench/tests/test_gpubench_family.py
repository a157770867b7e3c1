"""A family and a driver that are not VToonify's, added as files only: a
layout of BENCHMARK.json and gpubench/ files in a temporary directory, with
a configuration of the "blur" family (the program's B3 blur on seeded
frames, held to a plain depthwise `F.conv2d`), a traffic of the "loop"
driver (batches in a closed loop) and a per-layer metric of its own. One
cell runs end to end through `run_cell` on the CPU; the check passes, and
an output altered where B3 produces it fails it, as does the control."""

import json

import pytest
import torch

from gpubench import manifest, run

torch.set_num_threads(2)
SEED = 2 ** 31 + 41

BLUR_FAMILY = '''
"""The blur family: the program's blur (vtoonify_tpu_torch.ops.upfirdn2d.blur,
B3 on the card) with seeded taps, on seeded float32 frames."""

import torch
import torch.nn.functional as F

from gpubench.seeds import derive_seed


def draw_weights(config, seed, device):
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 0))
    return {"taps": torch.rand(config["taps"], generator=gen, device=device) + 0.5}


def build_program(config, traffic, state, device, devices, phases):
    from vtoonify_tpu_torch.ops.upfirdn2d import blur, make_kernel

    k = make_kernel(state["taps"].cpu().numpy())
    pad = tuple(config["pad"])
    return lambda x: blur(x, k, pad)


def make_inputs(config, traffic, seed, device):
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    h, w = traffic["frame_hw"]
    return torch.randn((traffic["pool"], config["channels"], h, w), generator=gen,
                       device=device)


def _reference(config, seed, x, dtype):
    taps = draw_weights(config, seed, x.device)["taps"].double()
    k = taps / taps.sum()
    k2 = torch.flip(torch.outer(k, k), (0, 1))
    c = x.shape[1]
    p0, p1 = config["pad"]
    w = k2.expand(c, 1, *k2.shape).to(dtype)
    return F.conv2d(F.pad(x.to(dtype), [p0, p1, p0, p1]), w, groups=c)


def _numbers(got, ref):
    return {"max_abs": (got.double() - ref.double()).abs().max().item()}


def output_numbers(config, traffic, seed, samples, device):
    pool = make_inputs(config, traffic, seed, device)
    ref = _reference(config, seed, pool[[k for k, _ in samples]], torch.float64)
    return [_numbers(out, ref[j]) for j, (_, out) in enumerate(samples)]


def control_numbers(config, traffic, seed, device):
    x = make_inputs(config, traffic, seed, device)[: traffic["check_frames"]]
    ref = _reference(config, seed, x, torch.float64)
    low = _reference(config, seed, x, torch.bfloat16)
    return [_numbers(low[j], ref[j]) for j in range(len(x))]


def stderr_lines(run):
    return [f"blur batches {run.card_batches_traced}"]
'''

LOOP_DRIVER = '''
"""The loop driver: batches of the pool through the program, closed loop."""

import time

from gpubench import window as W


def batch(program, traffic):
    return traffic["batch"]


def drive(run, program, inputs, sampler, trace):
    b, n_pool = run.batch, len(inputs)
    t = time.perf_counter()
    program(inputs[:b])
    run.phases["warmup"] = time.perf_counter() - t

    def window():
        run.setup_s = time.perf_counter() - W.T_START
        t_end = time.perf_counter() + run.seconds
        n = 0
        while time.perf_counter() < t_end:
            idx = [(n * b + j) % n_pool for j in range(b)]
            t_a = time.perf_counter()
            out = program(inputs[idx])
            run.latencies_s.append(time.perf_counter() - t_a)
            run.dispatch_s.append(run.latencies_s[-1])
            for j, k in enumerate(idx):
                sampler.offer(n * b + j, k, lambda o=out[j]: o)
            n += 1
        run.attempted = run.done_in_window = run.frames_traced = n * b
        run.card_batches_traced = n
    W.windowed(run, window, trace)
'''

BATCH_MS = '''
def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    return 1e3 * sum(run.latencies_s) / len(run.latencies_s)
'''

BENCH = {
    "configs": [{"name": "blur-4tap", "file": "gpubench/configs/blur-4tap.json", "reduced": []}],
    "workloads": [{"name": "blur-small", "config": "blur-4tap", "traffic": "blur-small",
                   "chips": 1}],
    "end_to_end": [{"name": "fps", "unit": "frames/s", "better": "higher", "bound": 0.05},
                   {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25}],
    "per_layer": [{"name": "batch_ms.blur", "unit": "ms", "better": "lower", "moves": "fps"}],
}
FILES = {
    "configs/blur-4tap.json": {"name": "blur-4tap", "family": "blur", "taps": 4, "pad": [2, 1],
                               "channels": 3},
    "traffic/blur-small.json": {"driver": "loop", "frame_hw": [24, 40], "pool": 6, "batch": 4,
                                "dp": 1, "check_frames": 5},
    "limits/blur-small.json": {"limits": {"max_abs": 1e-5}},
    "families/blur.py": BLUR_FAMILY,
    "drivers/loop.py": LOOP_DRIVER,
    "metrics/batch_ms.blur.py": BATCH_MS,
}


@pytest.fixture
def cell(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    for rel, body in FILES.items():
        path = tmp_path / "gpubench" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body if isinstance(body, str) else json.dumps(body))
    return manifest.load_cell("blur-small", root=tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_family_and_driver_run_a_cell(cell, trace, capsys):
    res = run.run_cell(cell, SEED, 0.5, trace, devices=["cpu"])
    assert res["correct"], res["check"]
    assert res["attempted"] >= 4 and res["readings"]["max_abs"] < 1e-5
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    if trace:
        assert res["metrics"]["batch_ms.blur"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"fps", "setup_s"}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    assert "gpubench: blur batches " in capsys.readouterr().err


def test_an_altered_output_fails_the_check(cell, monkeypatch):
    """B3's output shifted by one column where it is produced."""
    from vtoonify_tpu_torch.ops import kernels

    orig = kernels.upfirdn2d
    monkeypatch.setattr(kernels, "upfirdn2d",
                        lambda *a, **k: torch.roll(orig(*a, **k), 1, dims=3))
    res = run.run_cell(cell, SEED, 0.5, False, devices=["cpu"])
    assert not res["correct"]


def test_the_control_fails_the_check(cell):
    nums = manifest.family(cell).control_numbers(cell.config, cell.traffic, SEED, "cpu")
    assert len(nums) == cell.traffic["check_frames"]
    assert not run.judge(nums, cell.limits)[0]
