"""ctypes binding over the native slidetiff engine."""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .native.build import build


class _Lib:
    _lib = None

    @classmethod
    def get(cls):
        if cls._lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            lib.st_open.restype = ctypes.c_void_p
            lib.st_open.argtypes = [ctypes.c_char_p]
            lib.st_close.argtypes = [ctypes.c_void_p]
            for fn in ("st_channels", "st_levels", "st_bits",
                       "st_sample_format"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            for fn in ("st_mpp_x", "st_mpp_y"):
                getattr(lib, fn).restype = ctypes.c_double
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.st_level_dims.restype = ctypes.c_int
            lib.st_level_dims.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
            lib.st_description.restype = ctypes.c_int
            lib.st_description.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            lib.st_read_region.restype = ctypes.c_int
            lib.st_read_region.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
            lib.st_write_pyramid.restype = ctypes.c_int
            lib.st_write_pyramid.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_char_p,
                ctypes.c_int]
            lib.st_writer_open.restype = ctypes.c_void_p
            lib.st_writer_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_char_p, ctypes.c_int]
            lib.st_writer_write_band.restype = ctypes.c_int
            lib.st_writer_write_band.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            lib.st_writer_close.restype = ctypes.c_int
            lib.st_writer_close.argtypes = [ctypes.c_void_p]
            lib.st_writer_abort.argtypes = [ctypes.c_void_p]
            cls._lib = lib
        return cls._lib


_FMT_DTYPE = {
    (1, 1): np.uint8, (1, 2): np.uint16, (1, 4): np.uint32,
    (2, 1): np.int8, (2, 2): np.int16, (2, 4): np.int32,
    (3, 4): np.float32,
}

COMPRESSION = {"none": 1, "lzw": 5, "jpeg": 7, "deflate": 8}


class TiffSlide:
    """Low-level pyramidal TIFF handle (one per thread)."""

    def __init__(self, path: str):
        self._lib = _Lib.get()
        self._h = self._lib.st_open(str(path).encode())
        if not self._h:
            raise IOError(f"slidetiff: cannot open {path}")
        self.path = str(path)
        self.n_channels = self._lib.st_channels(self._h)
        self.n_levels = self._lib.st_levels(self._h)
        bits = self._lib.st_bits(self._h)
        fmt = self._lib.st_sample_format(self._h)
        self.dtype = np.dtype(_FMT_DTYPE.get((fmt, bits // 8), np.uint8))
        self.mpp = (self._lib.st_mpp_x(self._h) or None)
        self.level_dimensions = []
        for lvl in range(self.n_levels):
            w = ctypes.c_int64()
            h = ctypes.c_int64()
            self._lib.st_level_dims(self._h, lvl, ctypes.byref(w), ctypes.byref(h))
            self.level_dimensions.append((w.value, h.value))

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    @property
    def description(self) -> str:
        buf = ctypes.create_string_buffer(1 << 20)
        self._lib.st_description(self._h, buf, len(buf))
        return buf.value.decode(errors="replace")

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """(x, y) top-left in level coords, (w, h) -> HWC array, zero-padded
        out of bounds (slidevips parity: reader.py:246-297)."""
        x, y = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        out = np.zeros((h, w, self.n_channels), self.dtype)
        rc = self._lib.st_read_region(
            self._h, level, x, y, w, h,
            out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError(f"slidetiff: read_region failed rc={rc} on {self.path}")
        return out

    def close(self):
        if self._h:
            self._lib.st_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_pyramid(path: str, data: np.ndarray, *, n_levels: int = 1,
                  tile_size: int = 512, mpp: float = 0.0,
                  ome_xml: str = "", compression: str = "deflate") -> None:
    """Write a tiled pyramidal (OME-)TIFF.

    data: [C, H, W] (planar) or [H, W, C]/[H, W]; dtype uint8/uint16/float32.
    """
    if data.ndim == 2:
        data = data[None]
    elif data.ndim == 3 and data.shape[-1] <= 64 and data.shape[0] > 64:
        data = np.ascontiguousarray(np.moveaxis(data, -1, 0))
    c, h, w = data.shape
    data = np.ascontiguousarray(data)
    if data.dtype == np.uint8:
        fmt, bps = 1, 1
    elif data.dtype == np.uint16:
        fmt, bps = 1, 2
    elif data.dtype == np.int32:
        fmt, bps = 2, 4
    elif data.dtype == np.float32:
        fmt, bps = 3, 4
    else:
        raise ValueError(f"unsupported dtype {data.dtype}")
    lib = _Lib.get()
    rc = lib.st_write_pyramid(
        str(path).encode(), data.ctypes.data_as(ctypes.c_char_p),
        w, h, c, bps, fmt, int(n_levels), int(tile_size), float(mpp or 0.0),
        ome_xml.encode(), COMPRESSION[compression])
    if rc != 0:
        raise IOError(f"slidetiff: write_pyramid failed rc={rc} for {path}")


_DTYPE_FMT = {
    np.dtype(np.uint8): (1, 1), np.dtype(np.uint16): (1, 2),
    np.dtype(np.int32): (2, 4), np.dtype(np.float32): (3, 4),
}


class PyramidWriter:
    """Streaming pyramidal (OME-)TIFF writer with bounded memory.

    Accepts planar ``[C, band_h, W]`` row-bands in raster order via
    ``write_band``; the native engine spills them to a scratch file next to
    the output and, on ``close``, streams tiles + 2x-reduced SubIFD levels
    from disk — peak RAM is one tile band, independent of slide size. This
    is the counterpart of the reference's bounded-RAM WSI writes
    (per-channel temp TIFFs + arrayjoin in mif_cleaning.py:157-182, HDF5
    flow spill in cellpose_wsi_inference.py:161-185). Output bits are
    identical to ``write_pyramid`` on the materialized array (same tile and
    reduction arithmetic).
    """

    def __init__(self, path: str, *, width: int, height: int,
                 n_channels: int, dtype=np.uint8, n_levels: int = 1,
                 tile_size: int = 512, mpp: float = 0.0, ome_xml: str = "",
                 compression: str = "deflate"):
        fmt, bps = _DTYPE_FMT.get(np.dtype(dtype), (None, None))
        if fmt is None:
            raise ValueError(f"unsupported dtype {dtype}")
        self.path = str(path)
        self.width, self.height = int(width), int(height)
        self.n_channels = int(n_channels)
        self.dtype = np.dtype(dtype)
        self.y_filled = 0
        self._lib = _Lib.get()
        self._h = self._lib.st_writer_open(
            self.path.encode(), self.width, self.height, self.n_channels,
            bps, fmt, int(n_levels), int(tile_size), float(mpp or 0.0),
            ome_xml.encode(), COMPRESSION[compression])
        if not self._h:
            raise IOError(f"slidetiff: writer_open failed for {path}")

    def write_band(self, band: np.ndarray) -> None:
        """band: [C, band_h, W] (or [band_h, W] for C == 1), raster order."""
        if band.ndim == 2:
            band = band[None]
        if band.shape[0] != self.n_channels or band.shape[2] != self.width:
            raise ValueError(
                f"band {band.shape} != [C={self.n_channels}, ., "
                f"W={self.width}]")
        band = np.ascontiguousarray(band, dtype=self.dtype)
        rc = self._lib.st_writer_write_band(
            self._h, band.ctypes.data_as(ctypes.c_char_p),
            int(band.shape[1]))
        if rc != 0:
            raise IOError(f"slidetiff: write_band failed rc={rc}")
        self.y_filled += int(band.shape[1])

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, None
            rc = self._lib.st_writer_close(h)
            if rc != 0:
                raise IOError(
                    f"slidetiff: writer_close failed rc={rc} "
                    f"({self.y_filled}/{self.height} rows written)")

    def abort(self) -> None:
        if self._h:
            h, self._h = self._h, None
            self._lib.st_writer_abort(h)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()

    def __del__(self):
        try:
            self.abort()
        except Exception:
            pass
