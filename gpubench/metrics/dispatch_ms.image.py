"""dispatch_ms.image: host ms per request from the call of process_batch until
it returns, before the fetch."""

from gpubench import readers


def read(run):
    return readers.request_dispatch_ms(run)
