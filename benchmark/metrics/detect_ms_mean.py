"""Mean time one sweep holds the detector in the stream's window: the time
inside `Detector.detect`, call to annos on the host, summed over every sweep
that the window started and divided by their number."""

from benchmark.lib import readers


def read(run):
    return readers.service_mean_ms(run)
