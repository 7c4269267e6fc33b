"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)."""

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(n_bytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take for the work: the larger of the
    bytes over the memory rate and the operations over the peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
