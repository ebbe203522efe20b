"""Median ms a frame of the program's detect span less its annos.fetch child: host work in series with the card."""

from benchmark.lib import spans


def read(run):
    return spans.detect_host_ms(run)
