"""The SwiGLU MLP's fc1 and gate (M = batch x S) against its roofline,
in %."""

from benchmark.metrics._common import op_roofline


def read(run):
    return op_roofline(run, "mlp", "swiglu_fc1", "bench.mlp")
