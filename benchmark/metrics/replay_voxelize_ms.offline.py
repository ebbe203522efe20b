"""Median device ms of the voxelizer inside a batch's replay, marks `start` → `voxelize`, a frame's share (none where the program places no `voxelize` mark)."""

from benchmark.lib import spans


def read(run):
    return spans.replay_ms(run, "start", "voxelize")
