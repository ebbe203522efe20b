"""Device ms per frame of decode and finalize (NMS), from the eager stage pass."""

from benchmark.lib import readers


def read(run):
    return readers.stage_device_ms(run, "postprocess")
