"""idle_launch_share.image: as idle_launch_share.video, for the single-frame
requests (%)."""

from gpubench import spans


def read(run):
    return spans.idle_inside_share(run, "vt::pipeline.launch")
