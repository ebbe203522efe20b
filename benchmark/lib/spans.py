"""The arithmetic behind the readers of the program's own spans, counters
and stage marks (`det3d_tpu_torch.utils.timing`, recording while a
profiler runs: the traced stretch of a `--trace 1` run).

Only what the program recorded after the run's set-up counts, so that a
process that runs several cells reads each run's own. A program without
the recorder, or a run in which it recorded nothing, reads None.
"""

from __future__ import annotations

import statistics


def _recorder():
    try:
        from det3d_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "replays") else None


def _since_ns(run) -> int:
    return int((run.t_start + (run.setup_s or 0.0)) * 1e9)


def spans(run) -> list:
    rec = _recorder()
    return [] if rec is None else rec.spans(_since_ns(run))


def counters(run) -> dict:
    rec = _recorder()
    return {} if rec is None else rec.counters(_since_ns(run))


def replays(run) -> list:
    rec = _recorder()
    return [] if rec is None else rec.replays(_since_ns(run))


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def detect_host_ms(run):
    """Median over frames of a `detect` span less its `annos.fetch` child:
    the host's work in series with the card."""
    sp = spans(run)
    fetch: dict[int, float] = {}
    for s in sp:
        if s.name == "annos.fetch" and s.parent is not None:
            fetch[s.parent] = fetch.get(s.parent, 0.0) + _ms(s)
    per = [_ms(s) - fetch.get(s.id, 0.0) for s in sp if s.name == "detect"]
    return statistics.median(per) if per else None


def replay_ms(run, first: str, last: str):
    """Median over the replays of the device ms from mark `first` to mark
    `last`, a frame's share of a batch's."""
    per = []
    for r in replays(run):
        marks = dict(r.marks)
        if first in marks and last in marks:
            per.append(marks[last] - marks[first])
    return statistics.median(per) / run.mix.get("batch", 1) if per else None


def frames(run) -> int:
    return counters(run).get("call.replays", 0) * run.mix.get("batch", 1)


def span_ms_per_frame(run, names: set[str]):
    """The spans named in `names`, summed, over the frames of the calls."""
    n = frames(run)
    if not n:
        return None
    total = sum(_ms(s) for s in spans(run) if s.name in names)
    return total / n if total > 0 else None


def staged_useful_pct(run):
    c = counters(run)
    staged, real = c.get("call.rows_staged", 0), c.get("call.rows_real", 0)
    return 100.0 * real / staged if staged else None
