"""Softmax attention's forward over q, k, v ``[B, S, H*D]``: the two
products q.k^T and p.v (``4 B H S^2 D`` operations); q, k and v read, the
output written."""


def work(b: int, s: int, hd: int, heads: int, itemsize: int):
    d = hd // heads
    flops = 4.0 * b * heads * s * s * d
    n_bytes = 4.0 * b * s * hd * itemsize
    return flops, n_bytes
