"""dispatch_ms.video: host ms per batch the video engine spends in
process_batch until it returns (its StageTimer's 'dispatch' total over
count)."""

from gpubench import readers


def read(run):
    return readers.stage_mean_ms(run, "dispatch")
