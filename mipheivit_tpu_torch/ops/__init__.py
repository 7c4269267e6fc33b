"""Kernel wrappers and the plain tensor ops around them."""
