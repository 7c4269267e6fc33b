"""Overlap stitching for sliding-window inference, in numpy.

Counterparts of ``_BandSink``, ``RollingAccumulator`` and ``_blend_window``
(``mipheivit_tpu/infer/wsi.py``), with the same arithmetic in the same
order, so the stitched uint8 output is bit-equal. They are ported rather
than imported: importing ``mipheivit_tpu.infer.wsi`` runs
``mipheivit_tpu/infer/__init__.py``, which imports jax.
"""

from __future__ import annotations

import numpy as np


class BandSink:
    """Array-shaped adapter so ``RollingAccumulator``'s sequential row writes
    stream straight into a ``PyramidWriter``: no full-slide mosaic in RAM."""

    def __init__(self, writer):
        self.writer = writer
        self.shape = (writer.n_channels, writer.height, writer.width)
        self.dtype = writer.dtype

    def __setitem__(self, key, value):
        self.writer.write_band(value)


class RollingAccumulator:
    """Bounded-memory overlap accumulator for raster-order tile streams.

    Keeps only the rows that can still receive contributions (one tile
    height + stride) in RAM as f32, channel-last in a ring buffer; rows that
    fall behind the write frontier are finalized to ``out``'s dtype into
    ``out`` (an array, memmap or ``BandSink`` of shape ``[C, H, W]``)."""

    def __init__(self, out, tile_size: int, stride: int):
        self.out = out
        self.c, self.h, self.w = out.shape
        self.band_rows = tile_size + stride
        self.acc = np.zeros((self.band_rows, self.w, self.c), np.float32)
        self.wsum = np.zeros((self.band_rows, self.w, 1), np.float32)
        self.base = 0            # slide row corresponding to logical row 0
        self.off = 0             # ring offset of logical row 0

    def _row_spans(self, r0: int, n: int):
        """Logical band rows [r0, r0+n) -> up to two physical ring spans."""
        p0 = (self.off + r0) % self.band_rows
        first = min(n, self.band_rows - p0)
        yield slice(p0, p0 + first), 0, first
        if first < n:
            yield slice(0, n - first), first, n

    def _flush_to(self, new_base: int):
        """Finalize slide rows [self.base, new_base)."""
        new_base = min(new_base, self.h)
        while self.base < new_base:
            n = min(new_base - self.base, self.band_rows)
            for span, s0, s1 in self._row_spans(0, n):
                chunk = self.acc[span] / np.maximum(self.wsum[span], 1e-6)
                self.out[:, self.base + s0:self.base + s1] = \
                    np.ascontiguousarray(chunk.astype(self.out.dtype).transpose(2, 0, 1))
                self.acc[span] = 0.0
                self.wsum[span] = 0.0
            self.off = (self.off + n) % self.band_rows
            self.base += n

    def add(self, pred_hwc: np.ndarray, tx: int, ty: int, window: np.ndarray,
            pre_windowed: bool = False):
        """Feather one ``[h, w, C]`` prediction in at (tx, ty). With
        ``pre_windowed`` the blend window was already multiplied into
        ``pred_hwc`` (on the device); only the weight plane is added here."""
        if ty > self.base + self.band_rows - pred_hwc.shape[0]:
            self._flush_to(ty - (self.band_rows - pred_hwc.shape[0]))
        if ty < self.base:
            raise ValueError("tiles must arrive in raster (y-ascending) order")
        cw = min(pred_hwc.shape[1], self.w - tx)
        ch = min(pred_hwc.shape[0], self.h - ty)
        xsl = slice(tx, tx + cw)
        for span, s0, s1 in self._row_spans(ty - self.base, ch):
            if pre_windowed:
                self.acc[span, xsl] += pred_hwc[s0:s1, :cw]
            else:
                self.acc[span, xsl] += pred_hwc[s0:s1, :cw] * window[s0:s1, :cw, None]
            self.wsum[span, xsl] += window[s0:s1, :cw, None]

    def finalize(self):
        self._flush_to(self.h)


def blend_window(tile: int, overlap: int) -> np.ndarray:
    """Separable ``[tile, tile]`` weight window: 1 in the core, a raised
    cosine over the overlap margin, so the weighted mean is smooth at seams."""
    w = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(overlap) + 0.5) / overlap)
        w[:overlap] = ramp
        w[tile - overlap:] = ramp[::-1]
    return np.outer(w, w)
