"""Host ms per frame in Detector.pad_points and postprocess.to_annos, from the window's spans."""

from benchmark.lib import readers


def read(run):
    return readers.host_io_ms(run)
