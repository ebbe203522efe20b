"""Device ms a frame of the CenterHead in the captured batch: stage marks neck → network of each replay, median over replays, over the batch."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "neck", "network")
