"""Median device ms of a batch-4 replay, first stage mark to last, per frame."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "start", "postprocess")
