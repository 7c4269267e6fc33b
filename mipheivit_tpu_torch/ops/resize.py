"""Resizes of the flagship path, with torch's ``F.interpolate`` as the reference.

The bicubic resize is applied as two small matmuls whose weights are taken
from ``F.interpolate`` itself (it resizes one-hot columns), so the numerics
are torch's. Measured on an H100 at the flagship re-grid
(``[64, 1536, 18, 18] -> 16x16``), ``F.interpolate(mode="bicubic")`` took
220 ms, half the whole forward: its CUDA kernel runs one thread per output
pixel and loops over batch and channels. The JAX package resizes by the
same separable matmuls (``mipheivit_tpu/ops/resize.py``) for its own
reasons. All functions take and return NCHW.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _bicubic_matrix(in_size: int, out_size: int, antialias: bool,
                    device: torch.device) -> torch.Tensor:
    """``[out, in]`` f32 weights of a 1-D bicubic resize, ``align_corners=False``:
    ``F.interpolate`` applied to the ``in`` one-hot columns. The images are
    two pixels wide: torch's antialiased path gets a width of one wrong.
    Kept per device: a copy from pageable host memory synchronizes the
    card's stream, which would stall every forward that re-grids. Made
    outside inference mode, so a matrix first built there can still be
    saved for a later training backward."""
    with torch.inference_mode(False):
        eye = torch.eye(in_size, dtype=torch.float32).reshape(in_size, 1, in_size, 1)
        cols = F.interpolate(eye.expand(-1, -1, -1, 2), size=(out_size, 2), mode="bicubic",
                             align_corners=False, antialias=antialias)
        return cols[:, 0, :, 0].T.contiguous().to(device)


def resize_bicubic(x, out_hw: Tuple[int, int], antialias: bool = False):
    """``F.interpolate(x, out_hw, mode="bicubic", align_corners=False,
    antialias=antialias)``, computed in f32 and returned in x's dtype
    (the encoder's 14 -> 16 feature re-grid, the position-embedding resample)."""
    (in_h, in_w), (out_h, out_w) = x.shape[-2:], out_hw
    mh = _bicubic_matrix(in_h, out_h, antialias, x.device)
    mw = _bicubic_matrix(in_w, out_w, antialias, x.device)
    y = torch.matmul(mh, torch.matmul(x.float(), mw.T))
    return y.to(x.dtype)


def resize_bilinear(x, out_hw: Tuple[int, int]):
    """``F.interpolate(x, out_hw, mode="bilinear", align_corners=False)``
    (the JAX package's ``resize_bilinear`` without antialias: the eval
    scripts' half-resolution forward)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def upsample2x_bilinear(x, align_corners: bool = False):
    """x2 bilinear upsample: ``align_corners=False`` for the fusion blocks,
    ``True`` for the HEMIT hybrids' ``nn.Upsample`` (the JAX package's
    ``resize_bilinear_nhwc(align_corners=True)``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


def resample_pos_embed(pos, new_grid: Tuple[int, int], num_prefix_tokens: int = 0,
                       old_grid: Optional[Tuple[int, int]] = None):
    """timm ``resample_abs_pos_embed``: bicubic with antialias, prefix tokens
    carried through untouched. ``pos``: ``[1, prefix + gh*gw, d]``."""
    prefix, body = pos[:, :num_prefix_tokens], pos[:, num_prefix_tokens:]
    if old_grid is None:
        side = int(round(body.shape[1] ** 0.5))
        old_grid = (side, side)
    if tuple(old_grid) == tuple(new_grid):
        return pos
    d = body.shape[-1]
    grid = body.reshape(1, old_grid[0], old_grid[1], d).permute(0, 3, 1, 2)
    grid = resize_bicubic(grid, new_grid, antialias=True)
    body = grid.permute(0, 2, 3, 1).reshape(1, new_grid[0] * new_grid[1], d)
    return torch.cat([prefix, body], dim=1)
