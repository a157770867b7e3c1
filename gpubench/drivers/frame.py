"""The "frame" driver: one client, closed loop: each request is one frame of
the pool through the program's `process_batch`, fetched to the host before
the next is sent.

Its inputs are `{"pool": (n, H, W, 3) uint8 numpy, "s_w": style code}`;
the traffic gives `batch` (1), `style_degree` and `warmup_requests`. Each
request's latency runs from the call until its frame is on the host.
"""

from __future__ import annotations

import time

import torch

from gpubench import window as W


def batch(pipe, traffic) -> int:
    return traffic["batch"]


def drive(run, pipe, inputs, sampler, trace):
    tr = run.traffic
    pool, s_w, d_s = inputs["pool"], inputs["s_w"], tr["style_degree"]
    t_warm = time.perf_counter()
    for i in range(tr["warmup_requests"]):
        out = pipe.process_batch(pool[i % len(pool)][None], s_w, d_s).cpu()
    buf = torch.empty(out.shape, dtype=out.dtype)
    buf.copy_(out)
    W.sync(run.cards)
    run.phases["warmup"] = time.perf_counter() - t_warm

    def window():
        run.setup_s = time.perf_counter() - W.T_START
        t_end = time.perf_counter() + run.seconds
        i = 0
        while time.perf_counter() < t_end:
            frame = pool[i % len(pool)][None]
            t_a = time.perf_counter()
            with W.span("gpubench.dispatch", trace):
                out = pipe.process_batch(frame, s_w, d_s)
            t_b = time.perf_counter()
            with W.span("gpubench.fetch", trace):
                # the client reuses its host buffer: a fresh pageable one a
                # request pays 4-33 ms of first touches, differing by process
                buf.copy_(out)
            t_c = time.perf_counter()
            run.latencies_s.append(t_c - t_a)
            run.dispatch_s.append(t_b - t_a)
            with W.span("gpubench.keep", trace):
                sampler.offer(i, i % len(pool), lambda: buf[0].numpy().copy())
            i += 1
        run.attempted = run.done_in_window = run.frames_traced = i
        run.card_batches_traced = i
    W.windowed(run, window, trace)
