"""Share of the traced stretch in which the card runs no kernel, copy or set."""

from benchmark.lib import readers


def read(run):
    return readers.device_idle_pct(run)
