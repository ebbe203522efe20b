"""Median device ms of voxelize and the anchor mask inside a frame's replay, between its first two stage marks."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "start", "preprocess")
