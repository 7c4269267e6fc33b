"""Serving around the generator, plainly: the H&E normalization and the
output codec."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize(x_uint8: torch.Tensor, mean: Sequence[float], std: Sequence[float]):
    """uint8 NHWC -> f32 ``(x - mean) / std`` (pixel units)."""
    m = torch.tensor(mean, dtype=torch.float32, device=x_uint8.device)
    s = torch.tensor(std, dtype=torch.float32, device=x_uint8.device)
    return (x_uint8.float() - m) / s


def codec(y: torch.Tensor) -> torch.Tensor:
    """Marker maps in (-0.9, 0.9) -> 0..255, before any cast."""
    return torch.clamp((y.float() + 0.9) / 1.8, 0.0, 1.0) * 255.0
