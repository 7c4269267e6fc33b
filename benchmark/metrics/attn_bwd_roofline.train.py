"""The encoder attention's backward (dQ, dK, dV at S 5334) against its
roofline, in %."""

from benchmark.metrics._common import op_roofline


def read(run):
    return op_roofline(run, "attn", "attention_bwd", "bench.attn_bwd")
