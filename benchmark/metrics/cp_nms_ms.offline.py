"""Device ms a frame of the rotated NMS call, rank cap and compaction: stage marks decode → postprocess of each replay, median over replays, over the batch."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "decode", "postprocess")
