"""The share of the traced window in which no kernel, copy or set ran on
the device, in %."""

from benchmark.metrics._common import idle_share


def read(run):
    return idle_share(run)
