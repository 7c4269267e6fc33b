"""Checkpoint file formats."""
