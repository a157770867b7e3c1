"""idle_share.video: the share of the traced window in which no device
operation ran, per card, averaged over the cards (%)."""

from gpubench import readers


def read(run):
    return readers.idle_share(run)
