"""The measured window's clock and helpers, shared by run.py and the drivers.

`T_START` is taken when this module is first imported. run.py imports it
before torch and everything else it needs, so a run's `setup_s` counts from
there to the moment a driver opens the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import contextlib  # noqa: E402

import torch  # noqa: E402

from gpubench.trace import WINDOW, Trace  # noqa: E402


def span(name, on):
    """A host span named `name` in the trace, or nothing when not tracing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def sync(cards):
    """Wait for every CUDA card in `cards` (CPU devices are skipped)."""
    for c in cards:
        if isinstance(c, int):
            torch.cuda.synchronize(c)


def windowed(run, window, trace):
    """Call `window()`; with `trace`, under torch.profiler inside the span
    `WINDOW`, and leave the reduced trace in `run.trace`."""
    if not trace:
        window()
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            window()
    t = time.perf_counter()
    run.trace = Trace(prof)
    run.phases["trace_reduction"] = time.perf_counter() - t
