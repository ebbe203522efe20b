"""Median time of one Detector.detect call in the window, without its wait in the queue."""

from benchmark.lib import readers


def read(run):
    return readers.service_p50_ms(run)
