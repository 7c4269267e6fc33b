"""Softmax attention's backward: dV = p^T.dO, dP = dO.v^T, dQ = dS.k and
dK = dS^T.q (``8 B H S^2 D`` operations; the recompute of q.k^T that a
kernel keeping no probabilities needs is not counted); q, k, v, the output,
its gradient and the f32 row log-sum-exp read, dq, dk and dv written."""


def work(b: int, s: int, hd: int, heads: int, itemsize: int):
    d = hd // heads
    flops = 8.0 * b * heads * s * s * d
    n_bytes = 8.0 * b * s * hd * itemsize + 4.0 * b * heads * s
    return flops, n_bytes
