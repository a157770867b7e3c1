"""upload_ms.video: host ms a batch that process_batch spends uploading the
frames and the style code (the program's `vt::pipeline.upload` seconds over
its `vt::pipeline.process_batch` calls)."""

from gpubench import spans


def read(run):
    return spans.per_call_ms(run, "vt::pipeline.upload", "vt::pipeline.process_batch")
