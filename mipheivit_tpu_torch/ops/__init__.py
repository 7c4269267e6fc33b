"""Kernel wrappers and the plain tensor ops around them."""
from .attention import dot_product_attention

__all__ = ["dot_product_attention"]
