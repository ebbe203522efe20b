"""torch.cuda.max_memory_reserved() when the window closes, the graphs' private pools included."""

from benchmark.lib import readers


def read(run):
    return readers.peak_gib(run)
