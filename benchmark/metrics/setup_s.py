"""Seconds from the process's start to the first timed call."""

from benchmark.lib import readers


def read(run):
    return readers.setup_s(run)
