"""b1_roofline.image: as b1_roofline.video, for the single-frame requests (%)."""

from gpubench import readers


def read(run):
    return readers.b1_roofline(run)
