"""Per-stage wall-clock timing of the host pipeline (`StageTimer`, a copy
of the class in vtoonify_tpu/utils/profiling.py). Device traces come from
`torch.profiler`."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


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
