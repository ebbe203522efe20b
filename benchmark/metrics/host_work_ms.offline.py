"""Host ms a frame in the program's pad, call.stage, call.launch and annos.format spans: host work in series with the card."""

from benchmark.lib import spans


def read(run):
    return spans.span_ms_per_frame(run, {"pad", "call.stage", "call.launch", "annos.format"})
