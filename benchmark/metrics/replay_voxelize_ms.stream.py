"""Median device ms of the voxelizer inside a frame's replay: marks `start` → `voxelize` (none where the program places no `voxelize` mark)."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "start", "voxelize")
