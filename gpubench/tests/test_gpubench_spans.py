"""The readers of the program's spans (`gpubench/spans.py` and its six
metrics) on hand-built traces, and on a tiny traced CPU run of each traffic
loop (the video engine's and the single frame's)."""

from types import SimpleNamespace

import pytest
import torch

from gpubench import manifest, run, spans
from gpubench.tests import tiny

torch.set_num_threads(2)
SEED = 2 ** 31 + 29

VIDEO = ("fetch_wait_ms.video", "fetch_copy_ms.video", "upload_ms.video",
         "idle_launch_share.video")
IMAGE = ("upload_ms.image", "idle_launch_share.image")


def _run(host, ops=None, lo=0.0, hi=10.0, cards=(0,)):
    """A finished run whose trace has the window [lo, hi], host events
    (start, end, name) that are all spans, and device ops per card."""
    trace = SimpleNamespace(lo=lo, hi=hi, window_s=hi - lo,
                            host=[(a, b, n, True) for a, b, n in host],
                            ops={c: [(a, b, "k") for a, b in evs] for c, evs in (ops or {}).items()})
    return SimpleNamespace(trace=trace, cards=list(cards))


def _read(name, r):
    return manifest.metric_reader(name)(r)


def test_mean_and_per_call_spans():
    r = _run([(1.0, 1.1, "vt::engine.fetch_wait"), (2.0, 2.3, "vt::engine.fetch_wait"),
              (1.1, 1.15, "vt::engine.fetch_copy"),
              (0.5, 0.9, "vt::pipeline.process_batch"), (0.5, 0.51, "vt::pipeline.upload"),
              (3.0, 3.4, "vt::pipeline.process_batch"), (3.0, 3.01, "vt::pipeline.upload"),
              (3.01, 3.03, "vt::pipeline.upload"),  # a second replica's
              (-1.0, -0.5, "vt::engine.fetch_wait")])  # outside the window
    assert _read("fetch_wait_ms.video", r) == pytest.approx(200.0)
    assert _read("fetch_copy_ms.video", r) == pytest.approx(50.0)
    for name in ("upload_ms.video", "upload_ms.image"):
        assert _read(name, r) == pytest.approx(20.0)  # 40 ms over two calls


def test_idle_launch_share_is_the_idle_time_inside_launch_spans():
    # device busy [0, 2], [3, 6], [8, 10]: idle [2, 3] and [6, 8]
    # launch spans [1, 2.5] and [5, 7.5], [7, 7.2] nested inside: idle inside 0.5 + 1.5
    ops = {0: [(0.0, 2.0), (3.0, 4.0), (3.5, 6.0), (8.0, 10.0)],
           1: [(0.0, 10.0)]}  # a second card, never idle
    host = [(1.0, 2.5, "vt::pipeline.launch"), (5.0, 7.5, "vt::pipeline.launch"),
            (7.0, 7.2, "vt::pipeline.launch"), (2.5, 3.0, "vt::engine.fetch")]
    for name in ("idle_launch_share.video", "idle_launch_share.image"):
        assert _read(name, _run(host, ops)) == pytest.approx(20.0)
        assert _read(name, _run(host, ops, cards=(0, 1))) == pytest.approx(10.0)
    assert spans.overlap_s([(0, 2), (1, 3)], [(2.5, 5)]) == pytest.approx(0.5)


@pytest.mark.parametrize("name", VIDEO + IMAGE)
def test_a_missing_span_reads_none(name):
    """A program without the spans (or a run without a trace) reads None, and
    other spans are not taken for it."""
    assert _read(name, _run([(1.0, 2.0, "gpubench.dispatch"), (1.0, 2.0, "vt::upfirdn2d")],
                            {0: [(0.0, 1.0)]})) is None
    assert _read(name, SimpleNamespace(trace=None, cards=[0])) is None


@pytest.mark.parametrize("like,host_read", [
    ("vtd-video-400x360", ("fetch_copy_ms.video", "upload_ms.video")),
    ("vtt-video-400x360", ("fetch_copy_ms.video", "upload_ms.video")),
    ("vtd-image-1024", ("upload_ms.image",))])
def test_traced_run_reads_the_host_spans(like, host_read):
    """A tiny traced CPU run of each cell's loop: every reader of the
    program's spans that the cell lists is a number, but fetch_wait (a CPU
    batch records no event, so it reads None here)."""
    cell = tiny.cell(like, backbone="toonify" if like.startswith("vtt") else "dualstylegan")
    listed = {m["name"] for m in cell.per_layer}
    assert set(VIDEO if "video" in like else IMAGE) <= listed
    res = run.run_cell(cell, SEED, 2.0, True, devices=["cpu"])
    got = res["metrics"]
    for name in host_read:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    assert "fetch_wait_ms.video" not in got
    share = [n for n in got if n.startswith("idle_launch_share")]
    assert len(share) == 1 and 0 < got[share[0]]["value"] <= 100
