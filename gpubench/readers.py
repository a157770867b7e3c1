"""Arithmetic shared by the per-layer metric readers (`gpubench/metrics/`).

Each reader takes the finished run (`gpubench.run.Run`) and returns the
metric's value, or None where it finds nothing to read; the harness then
leaves the metric out of the result line.
"""

from __future__ import annotations

from gpubench import work


def stage_mean_ms(run, stage: str):
    """The engine StageTimer's mean host ms per call of `stage`."""
    rec = (run.stages or {}).get(stage)
    if not rec or not rec["count"]:
        return None
    return 1e3 * rec["total_s"] / rec["count"]


def request_dispatch_ms(run):
    """Mean host ms from a request's call of process_batch until it returns."""
    if not run.dispatch_s:
        return None
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s)


def mfu(run):
    """Frames done in the traced window x the frame graph's counted FLOPs,
    over the window's seconds x the dtype's peak x the cards used (%)."""
    if run.trace is None or not run.frames_traced:
        return None
    h, w = run.traffic["frame_hw"]
    flops = run.frames_traced * work.frame_flops(run.config, h, w)
    peak = work.PEAK_FLOPS[run.config["dtype"]] * len(run.cards)
    return 100.0 * flops / (run.trace.window_s * peak)


def b1_roofline(run):
    """The summed bound of the logical styled 3x3 convs of the batches in the
    traced window, over B1's device time there (%). The window runs until the
    last batch is fetched, so B1's time covers every batch it counts."""
    if run.trace is None or not run.card_batches_traced:
        return None
    seconds, launches = run.trace.op_seconds("modconv3x3")
    if not launches:
        return None
    h, w = run.traffic["frame_hw"]
    per_card = run.batch // run.traffic["dp"]
    bound = run.card_batches_traced * work.b1_bound_s(run.config["vtoonify"], h, w, per_card,
                                                      run.config["dtype"])
    return 100.0 * bound / seconds


def idle_share(run):
    """1 - busy / window, per card, averaged over the cards used (%)."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.mean_busy_s(run.cards) / run.trace.window_s)
