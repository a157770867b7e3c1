"""b1_roofline.video: B1's (the styled 3x3 conv's) share of its roofline: the
logical convs' summed bound over B1's device time in the traced window (%)."""

from gpubench import readers


def read(run):
    return readers.b1_roofline(run)
