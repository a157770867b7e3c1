"""fetch_wait_ms.video: host ms a batch the video engine waits, before its
fetch copy, for the device work queued ahead of it (the mean of the
program's `vt::engine.fetch_wait` spans)."""

from gpubench import spans


def read(run):
    return spans.mean_ms(run, "vt::engine.fetch_wait")
