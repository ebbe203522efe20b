"""95th percentile of how late the loop woke for a sweep that found it idle."""

from benchmark.lib import readers


def read(run):
    return readers.generator_late_p95_ms(run)
