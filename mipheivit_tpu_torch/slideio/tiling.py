"""Tissue-mask tiling (reference: slidevips-python/slidevips/tiling.py).

Otsu threshold on the channel-std of a thumbnail -> binary tissue mask ->
grid of level-0 tile positions filtered by tissue percentage, plus the
raster ordering helper used by the WSI writers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def get_locs_otsu(thumbnail_or_mask: np.ndarray, slide_dim,
                  tile_size_lvl0, tile_overlap: int = 0,
                  mask_thresh: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tile_positions [N,2] level-0 xy, tissue_percentages [N])."""
    if thumbnail_or_mask.dtype == bool:
        mask = thumbnail_or_mask
    else:
        if thumbnail_or_mask.ndim == 3 and thumbnail_or_mask.shape[-1] > 1:
            thumb_1d = np.uint8(thumbnail_or_mask.std(axis=-1))
        else:
            thumb_1d = np.uint8(np.squeeze(thumbnail_or_mask))
        import cv2

        _, mask = cv2.threshold(thumb_1d, 0, 255,
                                cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        mask = mask > 0

    slide_dim = np.asarray(slide_dim, np.float64)          # (w, h)
    tile_size_lvl0 = float(np.asarray(tile_size_lvl0).reshape(-1)[0]) \
        if np.ndim(tile_size_lvl0) else float(tile_size_lvl0)
    thumb_shape = np.roll(np.array(mask.shape[:2]), 1)     # (w, h)
    scale_ratio = slide_dim / thumb_shape
    scaled_tile = tile_size_lvl0 / scale_ratio
    scaled_overlap = tile_overlap / scale_ratio

    positions, percentages = [], []
    ys_thumb = np.arange(0, thumb_shape[1] + 1, scaled_tile[1] - scaled_overlap[1])
    ys = np.arange(0, slide_dim[1] + 1, tile_size_lvl0 - tile_overlap)
    xs_thumb = np.arange(0, thumb_shape[0] + 1, scaled_tile[0] - scaled_overlap[0])
    xs = np.arange(0, slide_dim[0] + 1, tile_size_lvl0 - tile_overlap)

    for y_t, y in zip(ys_thumb, ys):
        for x_t, x in zip(xs_thumb, xs):
            x0, y0 = int(x_t), int(y_t)
            x1 = int(x_t + scaled_tile[0])
            y1 = int(y_t + scaled_tile[1])
            tile = mask[y0:y1, x0:x1]
            if tile.size == 0:
                continue
            pct = np.count_nonzero(tile) / tile.size
            if pct > mask_thresh:
                positions.append((int(x), int(y)))
                percentages.append(pct)
    return np.asarray(positions, np.int64).reshape(-1, 2), np.asarray(percentages)


def order_tiles_horizontally(tile_positions: np.ndarray) -> np.ndarray:
    """Raster order (y-major, then x) — reference tiling.py helper."""
    idx = np.lexsort((tile_positions[:, 0], tile_positions[:, 1]))
    return tile_positions[idx]
