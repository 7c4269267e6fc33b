"""High-level slide reader with slidevips-parity API.

Reference: ``SlideVips`` (slidevips-python/slidevips/reader.py:24-378) —
pyramid open, channel selection, mode handling ("RGB" / "IF" / "GRAY"),
padded ``read_region``, thumbnails, thread-pooled ``read_regions``, and the
``reiter_fetch`` infinite-retry loop that papers over flaky NFS
(reader.py:354-378). Decode is host-side by design; the transfer to the
card happens downstream.
"""

from __future__ import annotations

import concurrent.futures as futures
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .tiffio import TiffSlide
from .ome import parse_channel_names


class SlideReader:
    """One logical slide; per-thread native handles under the hood."""

    def __init__(self, slide_path: str, channel_idxs: Optional[Sequence[int]] = None,
                 mode: str = "RGB", reiter_fetch: bool = False,
                 max_retries: int = 0):
        self.slide_path = str(slide_path)
        self.name = Path(slide_path).stem
        self.channel_idxs = list(channel_idxs) if channel_idxs is not None else None
        self.mode = mode
        self.reiter_fetch = reiter_fetch
        self.max_retries = max_retries  # 0 = infinite (reference behavior)
        self._local = threading.local()
        handle = self._handle()
        self.dimensions = handle.dimensions          # (w, h) level 0
        self.level_dimensions = handle.level_dimensions
        self.n_levels = handle.n_levels
        self.n_channels_file = handle.n_channels
        self.dtype = handle.dtype
        self.mpp = handle.mpp

    # -- handles ----------------------------------------------------------
    def _handle(self) -> TiffSlide:
        h = getattr(self._local, "handle", None)
        if h is None:
            h = self._open_backend()
            self._local.handle = h
        return h

    def _open_backend(self):
        """Native libtiff engine, except NDPI's single-strip JPEG layout
        which routes to the pure-Python restart-marker band decoder
        (reference reads NDPI via openslide — read_pyramid.py:31-40)."""
        if self.slide_path.lower().endswith(".ndpi"):
            from .ndpi import NdpiSlide, is_ndpi_strip_jpeg

            if is_ndpi_strip_jpeg(self.slide_path):
                return NdpiSlide(self.slide_path)
        return TiffSlide(self.slide_path)

    def reset(self):
        """Drop cached handles (called in worker init, reference:
        src/dataset.py:539-542)."""
        self._local = threading.local()

    # -- metadata ---------------------------------------------------------
    @property
    def n_channels(self) -> int:
        if self.channel_idxs is not None:
            return len(self.channel_idxs)
        return self.n_channels_file

    @property
    def channel_names(self) -> List[str]:
        names = parse_channel_names(self._handle().description)
        if names and self.channel_idxs is not None:
            names = [names[i] for i in self.channel_idxs if i < len(names)]
        return names

    def level_downsample(self, level: int) -> float:
        return self.dimensions[0] / self.level_dimensions[level][0]

    # -- reads ------------------------------------------------------------
    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """location (x, y) at the given level; returns HWC (or HW for one
        channel in IF/GRAY mode squeeze parity is NOT applied: always HWC,
        callers squeeze)."""
        attempt = 0
        while True:
            try:
                arr = self._handle().read_region(location, level, size)
                break
            except Exception:
                if not self.reiter_fetch:
                    if self.slide_path.lower().endswith(".ndpi"):
                        # NDPI's single-strip restart-marker JPEG encoding
                        # is beyond stock libtiff (reference opens it via
                        # openslide — read_pyramid.py:31-40); standard-TIFF
                        # NDPI files read fine.
                        raise IOError(
                            f"read failed on NDPI slide {self.slide_path}: "
                            "this file likely uses NDPI's non-standard "
                            "JPEG strip layout — convert it once with "
                            "preprocessings/convert_to_ometiff.py (or "
                            "openslide/vips) and use the OME-TIFF.")
                    raise
                attempt += 1
                if self.max_retries and attempt >= self.max_retries:
                    raise
                time.sleep(min(0.1 * attempt, 5.0))
                self.reset()
        if self.channel_idxs is not None:
            arr = arr[..., self.channel_idxs]
        if self.mode == "RGB" and arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        return arr

    def read_regions(self, locations: Sequence[Tuple[int, int]], level: int,
                     sizes: Sequence[Tuple[int, int]],
                     num_workers: int = 4) -> List[np.ndarray]:
        with futures.ThreadPoolExecutor(num_workers) as pool:
            return list(pool.map(
                lambda args: self.read_region(args[0], level, args[1]),
                zip(locations, sizes)))

    def get_thumbnail(self, max_size: Tuple[int, int] = (1024, 1024)) -> np.ndarray:
        """Smallest pyramid level resized down to max_size (cv2 area)."""
        import cv2

        lvl = self.n_levels - 1
        w, h = self.level_dimensions[lvl]
        arr = self.read_region((0, 0), lvl, (w, h))
        scale = min(max_size[0] / w, max_size[1] / h, 1.0)
        if scale < 1.0:
            arr = resize(arr, (int(w * scale), int(h * scale)), cv2.INTER_AREA)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr

    def best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for lvl in range(self.n_levels):
            if self.level_downsample(lvl) <= downsample + 1e-9:
                best = lvl
        return best

    def close(self):
        h = getattr(self._local, "handle", None)
        if h is not None:
            h.close()


def resize(arr: np.ndarray, size: Tuple[int, int], interpolation: int) -> np.ndarray:
    """``cv2.resize`` of an ``[H, W]`` or ``[H, W, C]`` array to ``size``
    (w, h) for any C. cv2's area resampling at a fractional downscale takes
    at most 4 channels; there a wider array goes through it 4 channels at a
    time (each channel is resampled on its own). Everywhere else the array
    goes through whole, as cv2 takes it (its results there depend on C)."""
    import cv2

    h, w = arr.shape[:2]
    sx, sy = w / size[0], h / size[1]
    fractional_area = (interpolation == cv2.INTER_AREA and sx >= 1 and sy >= 1
                       and not (sx.is_integer() and sy.is_integer()))
    if arr.ndim == 2 or arr.shape[-1] <= 4 or not fractional_area:
        return cv2.resize(arr, size, interpolation=interpolation)
    parts = [cv2.resize(arr[..., c:c + 4], size, interpolation=interpolation)
             for c in range(0, arr.shape[-1], 4)]
    return np.concatenate([p[..., None] if p.ndim == 2 else p for p in parts], axis=-1)


# Back-compat alias matching the reference class name
SlideVips = SlideReader
