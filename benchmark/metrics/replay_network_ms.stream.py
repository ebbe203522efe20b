"""Median device ms of the batch-1 network inside a frame's replay, between its middle stage marks."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "preprocess", "network")
