"""Kernel wrappers and the plain tensor ops around them."""
from .attention import dot_product_attention
from .segment_pool import nucleus_pool, segment_mean_pool

__all__ = ["dot_product_attention", "nucleus_pool", "segment_mean_pool"]
