"""Reduce a torch.profiler trace of the measured window to what the readers
need: per card, the union of the intervals in which a device operation ran
(kernels, copies, sets), each operation's time by name, and the longest
device-idle gaps labelled with what the host was doing.

The window is the host span `WINDOW` that the harness opens around the
measured work. Overlapping operations count once: busy time is the length
of the union of their intervals within the window, not the sum of their
durations.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
from torch.autograd import DeviceType

WINDOW = "gpubench.window"
ANNOTATIONS = ("gpubench.", "vt::")


def _kineto_events(prof):
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no kineto results")
    return results.events()


def _is_annotation(e, name: str) -> bool:
    """A record_function range (the harness's `gpubench.*`, the program's
    `vt::*`), on the host or as its device-side span."""
    flag = getattr(e, "is_user_annotation", None)
    return (flag is not None and flag()) or name.startswith(ANNOTATIONS)


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps between the union of intervals, in [lo, hi]."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """The reduced trace. Times in seconds."""

    def __init__(self, prof):
        window = None
        dev = defaultdict(list)        # card -> [(start, end, name)]
        host = []                      # (start, end, name, is_span)
        for e in _kineto_events(prof):
            name = e.name()
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            annotation = _is_annotation(e, name)
            if e.device_type() == DeviceType.CUDA:
                if not annotation:  # kernels, copies, sets
                    dev[e.device_index()].append((start, end, name))
                continue
            if name == WINDOW:
                window = (start, end)
            host.append((start, end, name, annotation))
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW!r} span")
        self.lo, self.hi = window
        self.window_s = self.hi - self.lo
        self.ops = {c: [(max(a, self.lo), min(b, self.hi), n) for a, b, n in evs
                        if b > self.lo and a < self.hi] for c, evs in dev.items()}
        self.host = host

    @property
    def cards(self) -> list:
        return sorted(self.ops)

    def busy_s(self, card) -> float:
        return union_length((a, b) for a, b, _ in self.ops.get(card, ()))

    def mean_busy_s(self, cards) -> float:
        return sum(self.busy_s(c) for c in cards) / len(cards)

    def op_seconds(self, contains: str, cards=None) -> tuple:
        """(seconds, count) of the device operations whose name holds
        `contains`, summed over `cards` (default: all)."""
        total, n = 0.0, 0
        for c in self.cards if cards is None else cards:
            for a, b, name in self.ops.get(c, ()):
                if contains in name:
                    total += b - a
                    n += 1
        return total, n

    def top_ops(self, k=10, width=96) -> list:
        """[[name, seconds]]: the device operations that took the most time,
        summed over cards, names cut to `width` characters."""
        by = defaultdict(float)
        for evs in self.ops.values():
            for a, b, name in evs:
                by[name[:width]] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, card, k=10) -> list:
        """[[label, seconds]]: the longest gaps on `card` in which no device
        operation ran, each labelled by the host spans open at its middle:
        the outermost harness span and the innermost host op."""
        found = sorted(gaps([(a, b) for a, b, _ in self.ops.get(card, ())], self.lo, self.hi),
                       key=lambda g: g[0] - g[1])[:k]
        if not found:
            return []
        starts = np.array([h[0] for h in self.host])
        ends = np.array([h[1] for h in self.host])
        out = []
        for a, b in found:
            mid = 0.5 * (a + b)
            idx = np.nonzero((starts <= mid) & (ends >= mid))[0]
            spans = [self.host[i] for i in idx]
            outer = [h for h in spans if h[3] and h[2] != WINDOW]
            inner = [h for h in spans if not h[3]]
            label = "/".join(x for x in (
                min(outer, key=lambda h: h[0])[2] if outer else "",
                max(inner, key=lambda h: h[0])[2] if inner else "") if x) or "host idle"
            out.append([label, b - a])
        return out
