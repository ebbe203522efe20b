"""Device ms a frame of the heatmap decode, score gate, centre range and top-k: stage marks network → decode of each replay, median over replays, over the batch."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "network", "decode")
