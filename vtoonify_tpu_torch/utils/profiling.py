"""Per-stage wall-clock timing of the host pipeline (`StageTimer`, a copy
of the class in vtoonify_tpu/utils/profiling.py) and the trainers' device
trace of a window of steps (`StepTrace`, its port over `torch.profiler`)."""

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
    """Accumulating wall-clock stage timer for host-side pipeline phases
    (decode / preprocess / dispatch / fetch / encode)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1000 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }
