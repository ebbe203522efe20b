"""Host ms per frame in Detector.pad_points and postprocess.to_annos, timed alone after the window."""

from benchmark.lib import readers


def read(run):
    return readers.host_io_ms(run)
