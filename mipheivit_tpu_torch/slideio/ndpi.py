"""NDPI (Hamamatsu) slide backend: restart-marker JPEG band decoding.

NDPI files are TIFF-like containers whose levels are stored as a *single
JPEG strip* (RowsPerStrip == ImageLength) with DRI restart markers emitted
once per MCU row — out of spec for stock libtiff, which is why the native
engine cannot read them (the reference opens NDPI through openslide —
slidevips-python/slidevips/read_pyramid.py:31-40). This backend implements
the openslide approach in pure Python:

  * the TIFF IFD chain is parsed directly (classic + BigTIFF), no libtiff;
  * each level's JPEG stream is scanned once for its restart-marker
    offsets (entropy-coded segments, one MCU row each);
  * ``read_region`` re-assembles a tiny valid JPEG for just the MCU rows
    that cover the request — original header with the SOF height patched,
    the selected entropy segments with renumbered RST markers, EOI — and
    decodes it with OpenCV's libjpeg. Random access without ever decoding
    the gigapixel plane.

Levels without restart markers fall back to a whole-strip decode with an
LRU cache (fine for thumbnails/macro pages).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# TIFF tag ids
_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_DESCRIPTION = 270
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_XRES = 282
_TAG_RESUNIT = 296
_TAG_JPEG_TABLES = 347
_TAG_NDPI_MAGNIFICATION = 65421

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}


def parse_tiff_ifds(path: str) -> List[Dict[int, object]]:
    """Minimal IFD walk returning {tag: value} dicts per directory."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:2] == b"II":
            endian = "<"
        elif head[:2] == b"MM":
            endian = ">"
        else:
            raise IOError(f"{path}: not a TIFF container")
        magic = struct.unpack(endian + "H", head[2:4])[0]
        big = magic == 43
        if big:
            f.seek(8)
            next_off = struct.unpack(endian + "Q", f.read(8))[0]
        elif magic == 42:
            next_off = struct.unpack(endian + "I", head[4:8])[0]
        else:
            raise IOError(f"{path}: bad TIFF magic {magic}")

        ifds = []
        seen_offsets = set()
        while next_off:
            if next_off in seen_offsets or len(seen_offsets) > 4096:
                raise IOError(
                    f"{path}: cyclic or runaway IFD chain (malformed TIFF)")
            seen_offsets.add(next_off)
            f.seek(next_off)
            if big:
                n = struct.unpack(endian + "Q", f.read(8))[0]
                entry_size, cnt_fmt = 20, "Q"
            else:
                n = struct.unpack(endian + "H", f.read(2))[0]
                entry_size, cnt_fmt = 12, "I"
            raw = f.read(entry_size * n)
            tags: Dict[int, object] = {}
            for i in range(n):
                e = raw[i * entry_size:(i + 1) * entry_size]
                tag, typ = struct.unpack(endian + "HH", e[:4])
                count = struct.unpack(endian + cnt_fmt, e[4:4 + (8 if big else 4)])[0]
                inline = e[4 + (8 if big else 4):]
                size = _TYPE_SIZES.get(typ, 1) * count
                if size <= len(inline):
                    data = inline[:size]
                else:
                    off = struct.unpack(endian + cnt_fmt, inline)[0]
                    pos = f.tell()
                    f.seek(off)
                    data = f.read(size)
                    f.seek(pos)
                tags[tag] = _decode_tag(endian, typ, count, data)
            next_off = struct.unpack(endian + cnt_fmt,
                                     f.read(8 if big else 4))[0]
            ifds.append(tags)
        return ifds


def _decode_tag(endian, typ, count, data):
    if typ == 2:                                     # ASCII
        return data.split(b"\0")[0].decode("latin-1", "replace")
    fmt = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
           12: "d", 16: "Q", 17: "q"}.get(typ)
    if fmt:
        vals = struct.unpack(endian + fmt * count, data[:struct.calcsize(fmt) * count])
        return vals[0] if count == 1 else list(vals)
    if typ in (5, 10):                               # RATIONAL
        f2 = "I" if typ == 5 else "i"
        vals = struct.unpack(endian + f2 * (2 * count), data)
        out = [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(count)]
        return out[0] if count == 1 else out
    return data


class _JpegStream:
    """Marker map of one single-strip JPEG: header span, SOF height patch
    offset, MCU geometry, restart-segment spans inside the entropy data.

    ``plane_w``/``plane_h`` are the authoritative dimensions from the TIFF
    tags: gigapixel NDPI planes (>65535 px — the usual case for the base
    level of a 40x slide) cannot fit their width in the 16-bit SOF field
    and store 0 there, so the SOF values are only trusted as a fallback.
    """

    def __init__(self, buf: bytes, plane_w: int = 0, plane_h: int = 0):
        self.buf = buf
        self.dri = 0
        self.sof_height = 0
        self.sof_width = 0
        self.ncomp = 1
        self.sof_height_off = None
        max_h = max_v = 1
        i = 2                                         # skip SOI
        n = len(buf)
        while i < n - 1:
            if buf[i] != 0xFF:
                raise IOError("bad JPEG structure in NDPI strip")
            marker = buf[i + 1]
            if marker == 0xD8:
                i += 2
                continue
            seg_len = struct.unpack(">H", buf[i + 2:i + 4])[0]
            if marker in (0xC0, 0xC1, 0xC2):
                self.sof_height_off = i + 5
                self.sof_height, self.sof_width = struct.unpack(
                    ">HH", buf[i + 5:i + 9])
                self.ncomp = buf[i + 9]
                for c in range(self.ncomp):
                    hv = buf[i + 10 + 3 * c + 1]
                    max_h = max(max_h, hv >> 4)
                    max_v = max(max_v, hv & 0xF)
            elif marker == 0xDD:
                self.dri = struct.unpack(">H", buf[i + 4:i + 6])[0]
            elif marker == 0xDA:
                self.header_end = i + 2 + seg_len
                break
            i += 2 + seg_len
        else:
            raise IOError("no SOS marker in NDPI strip")
        self.mcu_w = 8 * max_h
        self.mcu_h = 8 * max_v
        self.width = plane_w or self.sof_width
        self.height = plane_h or self.sof_height
        self.segments: List[Tuple[int, int]] = []
        self._scan_entropy()

    def _scan_entropy(self):
        buf = self.buf
        start = self.header_end
        i = start
        n = len(buf)
        arr = np.frombuffer(buf, np.uint8)
        ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
        nxt = arr[ff + 1]
        specials = ff[(nxt >= 0xD0) & (nxt <= 0xD9)]
        seg_start = start
        for pos in specials:
            m = buf[pos + 1]
            if 0xD0 <= m <= 0xD7:
                self.segments.append((seg_start, pos))
                seg_start = pos + 2
            elif m == 0xD9:
                self.segments.append((seg_start, pos))
                seg_start = None
                break
        if seg_start is not None and seg_start < n:
            self.segments.append((seg_start, n))
        del i

    def mcus_per_row(self) -> int:
        return -(-self.width // self.mcu_w) if self.width else 0

    def rows_per_segment(self) -> Optional[int]:
        """Pixel rows per restart segment, when segments span whole MCU
        rows (DRI an integer multiple of the MCU row). None otherwise."""
        mpr = self.mcus_per_row()
        if not self.dri or not mpr or self.dri % mpr:
            return None
        return (self.dri // mpr) * self.mcu_h

    def segs_per_row(self) -> Optional[int]:
        """Restart segments per MCU row, when DRI evenly subdivides the
        row (sub-row segments — how gigapixel-wide planes are decodable
        in rectangular chunks). None otherwise."""
        mpr = self.mcus_per_row()
        if not self.dri or not mpr or mpr % self.dri:
            return None
        return mpr // self.dri

    def band_jpeg(self, seg0: int, seg1: int, band_rows: int,
                  band_width: int = 0) -> bytes:
        """Valid standalone JPEG for entropy segments [seg0, seg1).

        The SOF height is patched to ``band_rows``; the SOF width is
        patched to ``band_width`` when given (required when the original
        header stores width 0, and when decoding sub-row chunks).
        """
        width = band_width or self.sof_width
        if not 0 < width <= 0xFFFF or not 0 < band_rows <= 0xFFFF:
            raise IOError(
                f"NDPI band {width}x{band_rows} exceeds the 16-bit JPEG "
                "SOF field — cannot re-assemble a decodable band")
        parts = [bytearray(self.buf[:self.header_end])]
        parts[0][self.sof_height_off:self.sof_height_off + 4] = \
            struct.pack(">HH", band_rows, width)
        for j, (s, e) in enumerate(self.segments[seg0:seg1]):
            if j > 0:
                parts.append(bytes((0xFF, 0xD0 + ((j - 1) % 8))))
            parts.append(self.buf[s:e])
        parts.append(b"\xff\xd9")
        return b"".join(bytes(p) for p in parts)

    def full_jpeg(self) -> bytes:
        """The whole strip, with SOF dims patched from the TIFF tags when
        the header stores 0 (gigapixel quirk)."""
        if (self.sof_width, self.sof_height) == (self.width, self.height):
            return self.buf
        if not (0 < self.width <= 0xFFFF and 0 < self.height <= 0xFFFF):
            raise IOError(
                f"NDPI plane {self.width}x{self.height} exceeds the JPEG "
                "SOF limit and has no usable restart-marker structure — "
                "whole-strip decode impossible")
        out = bytearray(self.buf)
        out[self.sof_height_off:self.sof_height_off + 4] = \
            struct.pack(">HH", self.height, self.width)
        return bytes(out)


class NdpiSlide:
    """TiffSlide-interface backend for NDPI files (see module docstring)."""

    def __init__(self, path: str):
        self.path = str(path)
        ifds = parse_tiff_ifds(self.path)
        # pyramid levels only: NDPI marks macro/map pages with a negative
        # SourceLens (tag 65421); keep every positive-lens strip directory.
        levels = []
        for t in ifds:
            if _TAG_STRIP_OFFSETS not in t or not t.get(_TAG_WIDTH, 0):
                continue
            lens = t.get(_TAG_NDPI_MAGNIFICATION)
            if lens is not None and _as_scalar(lens) < 0:
                continue
            levels.append(t)
        if not levels:
            raise IOError(f"{path}: no image directories")
        levels.sort(key=lambda t: -int(t[_TAG_WIDTH]))
        self._levels = levels
        self._file = open(self.path, "rb")
        self._streams: Dict[int, _JpegStream] = {}
        self._full_cache: Dict[int, np.ndarray] = {}
        # widest band JPEG we will re-assemble (16-bit SOF limit); levels
        # wider than this go through the per-restart-segment wide path.
        # Overridable so tests can exercise the wide path on small planes.
        self._max_band_px = 0xFFFF

        w0, h0 = int(levels[0][_TAG_WIDTH]), int(levels[0][_TAG_HEIGHT])
        self.dimensions = (w0, h0)
        self.level_dimensions = [
            (int(t[_TAG_WIDTH]), int(t[_TAG_HEIGHT])) for t in levels]
        self.n_levels = len(levels)
        samples = levels[0].get(_TAG_SAMPLES, 3)
        self.n_channels = int(samples if np.isscalar(samples) else samples[0])
        self.dtype = np.uint8
        self.description = str(levels[0].get(_TAG_DESCRIPTION, ""))
        self.mpp = self._compute_mpp(levels[0])

    def _compute_mpp(self, tags) -> Optional[float]:
        xres = tags.get(_TAG_XRES)
        if not xres:
            return None
        unit = tags.get(_TAG_RESUNIT, 2)
        per_um = {2: xres / 25400.0, 3: xres / 10000.0}.get(unit)
        if not per_um:
            return None
        return 1.0 / per_um if per_um > 0 else None

    # -- decoding ---------------------------------------------------------
    def _strip_bytes(self, level: int) -> bytes:
        tags = self._levels[level]
        off = tags[_TAG_STRIP_OFFSETS]
        cnt = tags[_TAG_STRIP_COUNTS]
        off = off if np.isscalar(off) else off[0]
        cnt = cnt if np.isscalar(cnt) else cnt[0]
        self._file.seek(int(off))
        data = self._file.read(int(cnt))
        tables = tags.get(_TAG_JPEG_TABLES)
        if isinstance(tables, (bytes, bytearray)) and len(tables) > 4 \
                and not _has_tables(data):
            # abbreviated stream: splice the shared tables after SOI
            data = data[:2] + bytes(tables)[2:-2] + data[2:]
        return data

    def _stream(self, level: int) -> _JpegStream:
        st = self._streams.get(level)
        if st is None:
            w, h = self.level_dimensions[level]
            st = _JpegStream(self._strip_bytes(level), w, h)
            self._streams[level] = st
        return st

    def _decode(self, jpeg: bytes) -> np.ndarray:
        import cv2

        arr = cv2.imdecode(np.frombuffer(jpeg, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise IOError(f"{self.path}: JPEG band decode failed")
        if arr.ndim == 2:
            arr = arr[..., None]
        elif arr.shape[-1] == 3:
            arr = arr[..., ::-1]                      # BGR -> RGB
        return arr

    def _read_rows(self, level: int, y0: int, y1: int) -> Tuple[np.ndarray, int]:
        """Decoded rows covering [y0, y1); returns (array, first_row)."""
        w, h = self.level_dimensions[level]
        st = self._stream(level)
        rps = st.rows_per_segment()
        if rps is None or not st.segments or len(st.segments) < 2:
            arr = self._full_cache.get(level)
            if arr is None:
                arr = self._decode(st.full_jpeg())
                self._full_cache[level] = arr
            return arr, 0
        # One MCU row of margin each side: libjpeg's fancy chroma
        # upsampling interpolates across MCU-row boundaries, so rows at a
        # band edge only match the whole-plane decode when their true
        # neighbor rows are present in the band.
        seg0 = max(0, y0 // rps - 1)
        seg1 = min(-(-y1 // rps) + 1, len(st.segments))
        band_rows = min(seg1 * rps, h) - seg0 * rps
        jpeg = st.band_jpeg(seg0, seg1, band_rows, w)
        return self._decode(jpeg), seg0 * rps

    def _read_rows_wide(self, level: int, y0: int, y1: int,
                        x0: int, x1: int) -> Tuple[np.ndarray, int, int]:
        """Rectangular per-restart-segment decode for planes too wide for
        a single band JPEG (width 0 in the SOF, >65535 px — openslide's
        hamamatsu approach). Requires DRI to evenly subdivide the MCU row;
        returns (array, first_row, first_col).

        Caveat: chroma upsampling cannot interpolate across chunk seams
        (entropy decoding can only start at a restart marker), so
        subsampled streams may differ from a hypothetical whole-plane
        decode by ±1 LSB along chunk borders.
        """
        w, h = self.level_dimensions[level]
        st = self._stream(level)
        spr = st.segs_per_row()
        chunk_w = st.dri * st.mcu_w
        if spr is None or chunk_w > self._max_band_px:
            raise IOError(
                f"{self.path}: level {level} is {w}px wide (JPEG SOF "
                f"limit 65535) and its restart interval dri={st.dri} does "
                f"not subdivide the {st.mcus_per_row()}-MCU row into "
                "decodable chunks — unsupported NDPI layout")
        r0 = max(0, y0 // st.mcu_h)
        r1 = min(-(-y1 // st.mcu_h), -(-h // st.mcu_h))
        c0 = max(0, x0 // chunk_w)
        c1 = min(-(-x1 // chunk_w), spr)
        out = np.zeros((min(r1 * st.mcu_h, h) - r0 * st.mcu_h,
                        min(c1 * chunk_w, w) - c0 * chunk_w,
                        self.n_channels), np.uint8)
        for r in range(r0, r1):
            oy = (r - r0) * st.mcu_h
            ny = out.shape[0] - oy
            for c in range(c0, c1):
                seg = r * spr + c
                if seg >= len(st.segments):
                    break
                # decode the chunk at its full encoded MCU extent, crop on
                # paste (partial trailing MCUs are encoded full-size)
                arr = self._decode(st.band_jpeg(seg, seg + 1, st.mcu_h,
                                                chunk_w))
                ox = (c - c0) * chunk_w
                nx = out.shape[1] - ox
                out[oy:oy + st.mcu_h,
                    ox:ox + chunk_w] = arr[:ny, :nx, :self.n_channels]
        return out, r0 * st.mcu_h, c0 * chunk_w

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        x, y = int(location[0]), int(location[1])
        wreq, hreq = int(size[0]), int(size[1])
        w, h = self.level_dimensions[level]
        out = np.zeros((hreq, wreq, self.n_channels), np.uint8)
        y0 = max(0, y)
        y1 = min(h, y + hreq)
        x0 = max(0, x)
        x1 = min(w, x + wreq)
        if y1 > y0 and x1 > x0:
            if w > self._max_band_px:
                band, fy, fx = self._read_rows_wide(level, y0, y1, x0, x1)
            else:
                band, fy = self._read_rows(level, y0, y1)
                fx = 0
            sub = band[y0 - fy:y1 - fy, x0 - fx:x1 - fx]
            out[y0 - y:y0 - y + sub.shape[0],
                x0 - x:x0 - x + sub.shape[1]] = sub[..., :self.n_channels]
        return out

    def close(self):
        if getattr(self, "_file", None):
            self._file.close()
            self._file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _as_scalar(v) -> float:
    """First element of a possibly-list tag value."""
    return float(v[0]) if isinstance(v, (list, tuple)) else float(v)


def _has_tables(jpeg: bytes) -> bool:
    """True if the stream carries its own DQT before SOS."""
    i = 2
    while i < len(jpeg) - 3:
        if jpeg[i] != 0xFF:
            return False
        m = jpeg[i + 1]
        if m == 0xDB:
            return True
        if m == 0xDA:
            return False
        i += 2 + struct.unpack(">H", jpeg[i + 2:i + 4])[0]
    return False


def is_ndpi_strip_jpeg(path: str) -> bool:
    """True when any level is a single-strip JPEG (libtiff-hostile NDPI)."""
    try:
        ifds = parse_tiff_ifds(path)
    except Exception:
        return False
    for t in ifds:
        if t.get(_TAG_COMPRESSION) in (6, 7) \
                and int(t.get(_TAG_ROWS_PER_STRIP, 0) or 0) \
                >= int(t.get(_TAG_HEIGHT, 1) or 1) \
                and t.get(_TAG_WIDTH, 0) >= 64:
            return True
    return False
