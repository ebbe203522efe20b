"""Share of the point rows staged into a captured call that hold real points: 100 x call.rows_real / call.rows_staged."""

from benchmark.lib import spans


def read(run):
    return spans.staged_useful_pct(run)
