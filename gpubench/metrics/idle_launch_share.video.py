"""idle_launch_share.video: the share of the traced window in which no device
operation ran while the host was inside the program's `vt::pipeline.launch`
span, per card, averaged over the cards (%). idle_share.video less this is
the idle time the host's other work leaves."""

from gpubench import spans


def read(run):
    return spans.idle_inside_share(run, "vt::pipeline.launch")
