"""mfu.image: as mfu.video, for the single-frame requests (%)."""

from gpubench import readers


def read(run):
    return readers.mfu(run)
