"""The port's host spans on the CPU: `utils.profiling.span` with a timer,
under the profiler and with neither; the video engine's stages (the fetch
split into its wait and its copy); and `process_batch`'s upload and launch
inside its own span. A tiny VToonify-D from the port's seeded init, as in
tests/test_torch_pipeline.py's engine tests; no JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.pipeline import toonify as T
from vtoonify_tpu_torch.pipeline import video
from vtoonify_tpu_torch.utils import profiling
from vtoonify_tpu_torch.utils.profiling import StageTimer, span


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pipe():
    g = torch.Generator().manual_seed(21)
    cfg = V.VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2,
                           channel_max=256)
    vt = V.init_vtoonify(cfg, g)
    pipe = T.ToonifyPipeline(vt, cfg, B.init_bisenet(generator=g), dtype=torch.float32,
                             device="cpu")
    s_w = torch.randn((1, cfg.n_latent, 512), generator=g).numpy() * 0.5
    return pipe, s_w


def _spans(prof, prefix="vt::"):
    return [e for e in prof.events() if e.name.startswith(prefix)]


@pytest.mark.parametrize("name,key", [("engine.fetch_wait", "fetch_wait"),
                                      ("pipeline.upload", "upload"),
                                      ("fused_leaky_relu", "fused_leaky_relu")])
def test_span_adds_to_the_timer_under_its_key(name, key):
    timer = StageTimer()
    for _ in range(3):
        with span(name, timer):
            pass
    rec = timer.summary()
    assert list(rec) == [key] and rec[key]["count"] == 3 and rec[key]["total_s"] >= 0


def test_span_is_a_profiler_range_while_the_profiler_records():
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("engine.fetch", timer):
            with span("engine.fetch_copy"):
                torch.ones(4).sum()
    keys = {e.key for e in prof.key_averages()}
    assert {"vt::engine.fetch", "vt::engine.fetch_copy"} <= keys
    assert timer.counts == {"fetch": 1}


def test_span_without_timer_or_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = span("engine.decode"), span("pipeline.launch")
    assert a is b is profiling._NO_SPAN
    with a:
        pass


def test_engine_stages_split_the_fetch(tmp_path):
    """11 frames in batches of 4 (4, 4, 3) into the cv2 file writer: the
    stages the engine always had, with their counts, and the fetch split
    into its copy (a CPU batch waits on no event and queues no copy)."""
    pipe, s_w = _pipe()
    frames = np.random.RandomState(22).randint(0, 256, (11, 32, 32, 3)).astype(np.uint8)
    timer = StageTimer()
    result = video.toonify_frames(
        pipe, ((25.0, f) for f in frames),
        lambda fps, size: video._AsyncWriter(str(tmp_path / "out.mp4"), fps, size,
                                             timer=timer),
        scale_image=False, batch_size=4, max_in_flight=2, s_w=s_w, timer=timer)
    assert result.frames_written == 11
    counts = {k: v["count"] for k, v in result.stages.items()}
    # decode: every frame and the end of the stream; preprocess: all but the first
    assert {k: counts[k] for k in ("decode", "preprocess", "dispatch", "fetch", "encode")} == {
        "decode": 12, "preprocess": 10, "dispatch": 3, "fetch": 3, "encode": 11}
    assert counts["stack"] == counts["fetch_copy"] == counts["write"] == 3
    assert "fetch_wait" not in counts and "copy_enqueue" not in counts
    st = result.stages
    assert st["fetch_copy"]["total_s"] <= st["fetch"]["total_s"]


def test_process_batch_spans_nest_upload_and_launch():
    pipe, s_w = _pipe()
    frames = np.random.RandomState(5).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.process_batch(frames, s_w, 0.5)
    by = {}
    for e in _spans(prof):
        by.setdefault(e.name, []).append(e.time_range)
    (outer,) = by["vt::pipeline.process_batch"]
    for inner in ("vt::pipeline.upload", "vt::pipeline.launch"):
        (r,) = by[inner]
        assert outer.start <= r.start and r.end <= outer.end
    assert by["vt::pipeline.upload"][0].end <= by["vt::pipeline.launch"][0].start
    assert "vt::pipeline.gather" not in by  # one replica
    # the kernels' host ranges keep their names; the depth-to-space's is gone
    assert "vt::fused_leaky_relu" in by and "vt::upfirdn2d" in by
    assert "vt::depth_to_space2" not in by
