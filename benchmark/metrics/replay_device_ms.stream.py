"""Median device ms of a frame's replay, from its graph's first stage mark to its last."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "start", "postprocess")
