"""Median device ms of decode, NMS and finalize inside a frame's replay, between its last two stage marks."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "network", "postprocess")
