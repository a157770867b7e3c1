"""upload_ms.image: as upload_ms.video, a single-frame request."""

from gpubench import spans


def read(run):
    return spans.per_call_ms(run, "vt::pipeline.upload", "vt::pipeline.process_batch")
