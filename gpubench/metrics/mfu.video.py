"""mfu.video: the frame graph's counted FLOPs of the frames done in the traced
window, over its seconds x the bf16 peak x the cards (%)."""

from gpubench import readers


def read(run):
    return readers.mfu(run)
