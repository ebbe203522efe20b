"""Device ms per frame of voxelize and the anchor mask, from the eager stage pass."""

from benchmark.lib import readers


def read(run):
    return readers.stage_device_ms(run, "preprocess")
