"""Device ms per frame of the network (PFN, scatter, RPN, head) at the cell's batch, from the eager stage pass."""

from benchmark.lib import readers


def read(run):
    return readers.stage_device_ms(run, "network")
