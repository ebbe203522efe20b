"""The rotated NMS kernels (mask_tiles and sweep) as a share of their bound over their calls in the traced
stretch: a row's bound is the circle reject of its valid pairs and the clip of the pairs whose circles meet
at the float32 rate, or its boxes and flags at the HBM rate (the family's `nms_row_bound_s`), counted from
the reference's candidates of the compared frames; a call holds the rows the program counts (`nms.rows`)."""

import statistics

from benchmark.lib import spans


def read(run):
    k = getattr(run, "kernels", {}).get("nms")
    calls = getattr(run, "nms_calls", 0)
    frames = getattr(run, "nms_valid", None) or []
    bound = getattr(run.family, "nms_row_bound_s", None)
    c = spans.counters(run)
    replays, rows = c.get("call.replays", 0), c.get("nms.rows", 0)
    work = [(v, m) for f in frames for v, m in zip(f, getattr(f, "meeting", ()))]
    if not k or not calls or k[0] <= 0 or bound is None or not work or not replays or not rows:
        return None
    per_row = statistics.fmean(bound(v, m) for v, m in work)
    return 100.0 * per_row * (rows / replays) * calls / k[0]
