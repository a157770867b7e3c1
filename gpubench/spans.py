"""Arithmetic on the program's own host spans (`vt::*`, opened by
`vtoonify_tpu_torch.utils.profiling.span`) in a traced run's window, shared
by the readers of `gpubench/metrics/` that read them.

`run.trace.host` holds the window's host events as (start, end, name,
is_span), in seconds on the profiler's clock; `run.trace.ops` the device
operations per card. Each function returns None where the run has no trace
or the span is missing (a program without it), so the harness leaves the
metric out of the result line.
"""

from __future__ import annotations

from gpubench.trace import gaps, union_length


def intervals(run, name: str) -> list:
    """The (start, end) of each span `name` inside the traced window."""
    if run.trace is None:
        return []
    lo, hi = run.trace.lo, run.trace.hi
    return [(a, b) for a, b, n, is_span in run.trace.host
            if is_span and n == name and a >= lo and b <= hi]


def mean_ms(run, name: str):
    """The mean duration of the span `name`, in ms."""
    found = intervals(run, name)
    if not found:
        return None
    return 1e3 * sum(b - a for a, b in found) / len(found)


def per_call_ms(run, name: str, per: str):
    """The summed duration of the span `name` over the number of spans
    `per`, in ms: a span's host ms a call of `per`, whether it opens once or
    once a replica inside it."""
    found, calls = intervals(run, name), intervals(run, per)
    if not found or not calls:
        return None
    return 1e3 * sum(b - a for a, b in found) / len(calls)


def overlap_s(a_intervals, b_intervals) -> float:
    """The length of the intersection of the unions of two interval sets."""
    a = union_length(a_intervals)
    b = union_length(b_intervals)
    return a + b - union_length(list(a_intervals) + list(b_intervals))


def idle_inside_share(run, name: str):
    """The share (%) of the window in which no device operation ran on a
    card while the host was inside the span `name`, per card, averaged over
    the cards used."""
    inside = intervals(run, name)
    if not inside:
        return None
    tr = run.trace
    shares = []
    for card in run.cards:
        idle = gaps([(a, b) for a, b, _ in tr.ops.get(card, ())], tr.lo, tr.hi)
        shares.append(overlap_s(idle, inside) / tr.window_s)
    return 100.0 * sum(shares) / len(shares)
