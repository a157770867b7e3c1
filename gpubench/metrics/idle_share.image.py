"""idle_share.image: as idle_share.video, for the single-frame requests (%)."""

from gpubench import readers


def read(run):
    return readers.idle_share(run)
