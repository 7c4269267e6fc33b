"""The SwiGLU MLP's fc1 and gate: ``silu(x W_a^T + b_a) * (x W_g^T + b_g)``
for x ``[M, K]`` and the packed weight ``[2H, K]``: ``2 M K 2H`` operations;
x, the weight and the bias read, the ``[M, H]`` output written."""


def work(m: int, k: int, two_h: int, itemsize: int):
    flops = 2.0 * m * k * two_h
    n_bytes = (m * k + two_h * k + two_h + m * two_h // 2) * float(itemsize)
    return flops, n_bytes
