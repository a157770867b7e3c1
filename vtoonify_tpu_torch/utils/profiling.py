"""The port's host spans (`span`), per-stage wall-clock totals of the host
pipeline (`StageTimer`) and the trainers' device trace of a window of steps
(`StepTrace`, over `torch.profiler`)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StepTrace:
    """Trace a contiguous window of training steps (--profile N).

    Call `before(step)` ahead of a step and `after(step)` behind it; the
    steps [first_step, first_step + n_steps) are traced with torch.profiler
    (host, and the card when there is one) and written as a Chrome trace
    (Perfetto, chrome://tracing) under `logdir`."""

    def __init__(self, logdir: str, first_step: int, n_steps: int):
        self.logdir = logdir
        self.first = first_step
        self.last = first_step + n_steps - 1
        self._prof = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def before(self, step: int):
        if step == self.first:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()

    def _stop(self, note: str):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"steps_{self.first}-{self.last}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"{note} written to {path}", flush=True)

    def after(self, step: int, *results):
        if self._active and step == self.last:
            self._stop("device trace")

    def close(self):
        """Flush a trace still open after the training loop, so a --profile
        window that runs past the last iteration is written, not lost."""
        if self._active:
            self._stop("device trace (truncated window)")


class StageTimer:
    """Accumulating wall-clock totals of host-side pipeline stages, fed by
    `span` (the video engine's decode / preprocess / stack / dispatch /
    copy_enqueue / fetch / fetch_wait / fetch_copy / write / encode)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1000 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("key", "timer", "range", "t0")

    def __init__(self, name: str, timer, traced: bool):
        self.key = name.rsplit(".", 1)[-1]
        self.timer = timer
        self.range = (torch.profiler.record_function("vt::" + name)
                      if traced else None)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.timer is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timer is not None:
            self.timer.add(self.key, time.perf_counter() - self.t0)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, timer: StageTimer = None):
    """The port's one way to open a host span: `with span("engine.fetch", timer):`.

    While `torch.profiler` records on this thread, the span is the range
    `vt::<name>` (`record_function`), on the trace's clock beside the
    device's kernels and copies. With a `StageTimer`, its wall-clock
    duration is added to the timer under the key `name` after its last
    dot: `engine.fetch_wait` -> `fetch_wait`, `fused_leaky_relu` ->
    `fused_leaky_relu`. With neither, it returns one shared no-op context:
    no allocation, no clock read."""
    traced = torch.autograd._profiler_enabled()
    if timer is None and not traced:
        return _NO_SPAN
    return _Span(name, timer, traced)
