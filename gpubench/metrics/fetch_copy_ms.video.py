"""fetch_copy_ms.video: host ms a batch the video engine spends copying the
finished batch to the host (the mean of the program's
`vt::engine.fetch_copy` spans)."""

from gpubench import spans


def read(run):
    return spans.mean_ms(run, "vt::engine.fetch_copy")
