"""The encoder's attention op at 256 px (S 329 / 333) against its
roofline, in %."""

from benchmark.metrics._common import op_roofline


def read(run):
    return op_roofline(run, "attn", "attention", "bench.attn")
