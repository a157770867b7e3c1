"""The "engine" driver: a closed loop through the program's video engine
(`toonify_frames`) over the frame pool, cycled, until the window closes.

Its inputs are `{"pool": (n, H, W, 3) uint8 numpy, "s_w": style code}`;
the traffic gives `batch` (null: the engine's own choice), `max_in_flight`,
`style_degree` and `warmup_batches`. Every frame sent is written, after
the window if need be; the frames written inside it count.
"""

from __future__ import annotations

import time

import torch

from gpubench import window as W

FPS_TAG = 25.0  # the frame rate the engine's writer is opened with; unused


class Collector:
    """The engine's writer: counts every frame, times it, and offers the
    ones written before the window closed to the sampler."""

    def __init__(self, t_end: float, sampler, pool_size: int, start_at: int, span=False):
        self.t_end, self.sampler, self.pool, self.start = t_end, sampler, pool_size, start_at
        self.count = self.in_window = 0
        self.span = span

    def write(self, frame):
        t = time.perf_counter()
        k = self.count
        self.count += 1
        if t <= self.t_end:
            self.in_window += 1
            with W.span("gpubench.keep", self.span):
                # a view: the fetched batch it lies in stays alive, uncopied
                self.sampler.offer(k, (self.start + k) % self.pool, lambda: frame)

    def close(self):
        return self.count


class _Spanned:
    """The pipeline with each process_batch call inside a host span, for the
    trace's idle-gap labels; every other attribute is the pipeline's."""

    def __init__(self, pipe):
        self._pipe = pipe

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def process_batch(self, *args, **kwargs):
        with torch.profiler.record_function("gpubench.dispatch"):
            return self._pipe.process_batch(*args, **kwargs)


def _frames(pool, start_at, batch, deadline=None, limit=None):
    """(fps, frame) from the pool, cycled; stops at a batch boundary once
    `deadline` has passed, or after `limit` frames."""
    i = 0
    while True:
        if limit is not None and i >= limit:
            return
        if deadline is not None and i % batch == 0 and time.perf_counter() >= deadline:
            return
        yield FPS_TAG, pool[(start_at + i) % len(pool)]
        i += 1


def batch(pipe, traffic) -> int:
    from vtoonify_tpu_torch.pipeline.model_api import dynamic_batch_size

    if traffic["batch"] is not None:
        return traffic["batch"]
    h, w = traffic["frame_hw"]
    return dynamic_batch_size(w, h, on_accelerator=pipe.device.type == "cuda")


def drive(run, pipe, inputs, sampler, trace):
    from vtoonify_tpu_torch.pipeline.video import MemoryWriter, toonify_frames
    from vtoonify_tpu_torch.utils.profiling import StageTimer

    tr, b = run.traffic, run.batch
    pool, timer = inputs["pool"], StageTimer()
    # batch_size None leaves the engine its own choice, which `b` repeats
    t_warm = time.perf_counter()
    opts = dict(style_degree=tr["style_degree"], batch_size=tr["batch"],
                max_in_flight=tr["max_in_flight"],
                s_w=inputs["s_w"], scale_image=True, landmarker=None)
    toonify_frames(pipe, _frames(pool, 0, b, limit=tr["warmup_batches"] * b),
                   lambda fps, size: MemoryWriter(keep=False), **opts)
    start_at = (tr["warmup_batches"] * b) % len(pool)
    W.sync(run.cards)

    def window():
        run.setup_s = time.perf_counter() - W.T_START
        t0 = time.perf_counter()
        col = Collector(t0 + run.seconds, sampler, len(pool), start_at, span=trace)
        frames = _frames(pool, start_at, b, deadline=t0 + run.seconds)
        toonify_frames(_Spanned(pipe) if trace else pipe, frames, lambda fps, size: col,
                       timer=timer, **opts)
        W.sync(run.cards)
        # every frame sent is written, after the window if need be
        run.attempted = run.frames_traced = col.count
        run.done_in_window = col.in_window
        run.card_batches_traced = (col.count // b) * run.traffic["dp"]
    run.phases["warmup"] = time.perf_counter() - t_warm
    W.windowed(run, window, trace)
    run.stages = timer.summary()
