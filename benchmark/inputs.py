"""Inputs made from the seed on the device: H&E-like uint8 images and
mIF-like targets.

Every image is the same recipe at every seed: a smooth field (a coarse
normal draw, bicubically upsampled) mixes a haematoxylin and an eosin
colour, and fine normal noise is added; only the values change with the
seed, never the sizes, so every seed runs the same work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .weights import seed_key

# haematoxylin (purple), eosin (pink) and the background (pixel values)
HAEMATOXYLIN = (120.0, 60.0, 150.0)
EOSIN = (230.0, 150.0, 190.0)
BACKGROUND = 242


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_key(seed * 1_000_003 + stream))


def he_images(n: int, size: int, seed: int, device, stream: int = 0,
              chunk: int = 64) -> torch.Tensor:
    """``n`` uint8 H&E-like images ``[n, size, size, 3]`` on ``device``."""
    g = _generator(seed, stream, device)
    h = torch.tensor(HAEMATOXYLIN, device=device)
    e = torch.tensor(EOSIN, device=device)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    coarse = max(size // 16, 2)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        field = torch.randn((m, 2, coarse, coarse), generator=g, device=device)
        field = F.interpolate(field, size=(size, size), mode="bicubic", align_corners=False)
        mix = torch.sigmoid(2.0 * field[:, 0])[..., None]           # [m, size, size, 1]
        density = torch.sigmoid(field[:, 1] + 1.0)[..., None]
        rgb = mix * h + (1.0 - mix) * e
        rgb = density * rgb + (1.0 - density) * BACKGROUND
        rgb = rgb + 12.0 * torch.randn((m, size, size, 3), generator=g, device=device)
        out[i:i + m] = rgb.clamp(0.0, 255.0).to(torch.uint8)
    return out


def mif_targets(n: int, size: int, markers: int, seed: int, device, stream: int = 1,
                chunk: int = 8) -> torch.Tensor:
    """``n`` f32 mIF-like targets ``[n, size, size, markers]`` in (-0.9, 0.9)."""
    g = _generator(seed, stream, device)
    out = torch.empty((n, size, size, markers), dtype=torch.float32, device=device)
    coarse = max(size // 32, 2)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        field = torch.randn((m, markers, coarse, coarse), generator=g, device=device)
        field = F.interpolate(field, size=(size, size), mode="bilinear", align_corners=False)
        out[i:i + m] = (0.9 * torch.tanh(2.0 * field - 1.0)).permute(0, 2, 3, 1)
    return out
