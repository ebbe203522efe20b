"""Frames whose annos reached the host, over the whole window."""

from benchmark.lib import readers


def read(run):
    return readers.frames_per_s(run)
