"""Host ms a frame in the program's annos.fetch spans: the host waiting for the card to finish a batch."""

from benchmark.lib import spans


def read(run):
    return spans.span_ms_per_frame(run, {"annos.fetch"})
