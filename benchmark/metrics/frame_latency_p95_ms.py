"""95th percentile over every sweep due in the window of the time from its due time to its annos on the host; a sweep unfinished at the close counts its wait so far."""

from benchmark.lib import readers


def read(run):
    return readers.latency_p95_ms(run)
