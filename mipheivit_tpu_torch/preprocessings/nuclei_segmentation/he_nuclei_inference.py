"""H&E-side WSI nucleus segmentation, the HoverFast role (the port's copy
of ``preprocessings/nuclei_segmentation/he_nuclei_inference.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.nuclei_segmentation.he_nuclei_inference
      --slide_path S --out_path O [--polygons_json P] [--device cpu]

Reference: preprocessings/nuclei_segmentation/nuclei_he_wsi_hoverfast (a
modified HoverFast writing polygon JSON, rasterised to WSI label masks with
watershed expansion). With ``--polygons_json`` the HoverFast polygons are
rasterised; otherwise the haematoxylin channel (HED deconvolution,
``ops/hed.py::rgb2hed``, on the card unless ``--device cpu``; without a
card it raises) goes through the same watershed as the DAPI path. Output:
the 2-channel (labels int32, boundaries) pyramidal OME-TIFF.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..._device import resolve_device
from ...ops.hed import rgb2hed
from ...slideio import SlideReader
from .backends import classical_segment, expand_labels
from .wsi_nuclei_inference import segment_wsi, stream_labels_pyramid


def hematoxylin_segment(rgb_tile: np.ndarray, device=None) -> np.ndarray:
    """The haematoxylin channel of ``rgb_tile`` (HED deconvolution in f64 on
    ``device``: the card unless the caller asks for the CPU) as uint8, then
    the classical watershed."""
    hed = rgb2hed(torch.from_numpy(np.ascontiguousarray(rgb_tile)).to(resolve_device(device)))
    h_channel = (torch.clamp(hed[..., 0], 0, 1) * 255).to(torch.uint8)
    return classical_segment(h_channel.cpu().numpy())


def load_hoverfast_polygons(path):
    """HoverFast detection JSON(.gz): GeoJSON-style features whose
    ``geometry.coordinates[0]`` is the nucleus' exterior ring (reference:
    create_wsi_nuclei.py:148-155), or plain point lists."""
    import gzip

    if str(path).endswith(".gz"):
        with gzip.open(path, "rt") as f:
            data = json.loads(f.read())
    else:
        data = json.loads(Path(path).read_text())
    return [item["geometry"]["coordinates"][0] if isinstance(item, dict) else item
            for item in data]


def rasterize_polygons(polygons, shape, expansion_px: float = 0.0) -> np.ndarray:
    """Polygons -> one label raster (+ optional expansion) (reference:
    nuclei_he_wsi_hoverfast/create_wsi_nuclei.py)."""
    import cv2

    labels = np.zeros(shape, np.int32)
    for i, poly in enumerate(polygons):
        # vertices rounded, as rasterize_wsi_labels rounds them
        pts = np.rint(np.asarray(poly, np.float64)).astype(np.int32).reshape(-1, 1, 2)
        cv2.fillPoly(labels, [pts], i + 1)
    return expand_labels(labels, expansion_px)


def _bucket_polygons(polygons, tile_size: int, halo: int, shape):
    """Polygons bucketed by tile through their bounding boxes (the
    reference's shapely STRtree query, create_wsi_nuclei.py:81-92):
    ``{(ty, tx): [(global_idx, points), ...]}``."""
    h, w = shape
    buckets: dict = {}
    for i, poly in enumerate(polygons):
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        x0, y0 = pts.min(axis=0) - halo
        x1, y1 = pts.max(axis=0) + halo
        tx0, ty0 = max(int(x0 // tile_size), 0), max(int(y0 // tile_size), 0)
        tx1 = min(int(x1 // tile_size), max((w - 1) // tile_size, 0))
        ty1 = min(int(y1 // tile_size), max((h - 1) // tile_size, 0))
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                buckets.setdefault((ty, tx), []).append((i, pts))
    return buckets


def rasterize_wsi_labels(polygons, shape, tile_size: int = 2048, expansion_px: float = 4.0,
                         out=None) -> np.ndarray:
    """Polygons -> a whole-slide label plane with bounded RAM (reference:
    create_wsi_nuclei.py:89-114): per tile, the polygons that touch it are
    rasterised with their global index as the label and expanded, with a
    halo wide enough that only the core is written; the result equals a
    whole-plane pass. ``out`` may be an ``np.memmap``."""
    import cv2

    h, w = shape
    if out is None:
        out = np.zeros((h, w), np.int32)
    halo = int(np.ceil(expansion_px)) + 2
    for (ty, tx), items in sorted(_bucket_polygons(polygons, tile_size, halo, shape).items()):
        y0, x0 = max(ty * tile_size - halo, 0), max(tx * tile_size - halo, 0)
        y1, x1 = min((ty + 1) * tile_size + halo, h), min((tx + 1) * tile_size + halo, w)
        tile = np.zeros((y1 - y0, x1 - x0), np.int32)
        # ascending global id: the reference's paint order (later wins)
        for gid, pts in sorted(items, key=lambda item: item[0]):
            p = np.rint(pts - [x0, y0]).astype(np.int32).reshape(-1, 1, 2)
            cv2.fillPoly(tile, [p], gid + 1)
        if expansion_px > 0:
            tile = expand_labels(tile, expansion_px)
        cy0, cx0 = ty * tile_size, tx * tile_size
        cy1, cx1 = min((ty + 1) * tile_size, h), min((tx + 1) * tile_size, w)
        out[cy0:cy1, cx0:cx1] = tile[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_path", required=True, help="H&E WSI")
    parser.add_argument("--out_path", required=True)
    parser.add_argument("--polygons_json", default=None,
                        help="HoverFast polygon JSON; bypasses segmentation")
    parser.add_argument("--tile_size", type=int, default=2048)
    parser.add_argument("--halo", type=int, default=128)
    parser.add_argument("--expansion_px", type=float, default=3.0)
    parser.add_argument("--device", default=None,
                        help="where the HED deconvolution runs (default: the card)")
    args = parser.parse_args(argv)

    reader = SlideReader(args.slide_path, mode="RGB")
    scratch = args.out_path + ".labels.raw"
    if args.polygons_json:
        polys = load_hoverfast_polygons(args.polygons_json)
        w, h = reader.dimensions
        out = np.memmap(scratch, dtype=np.int32, mode="w+", shape=(h, w))
        labels = rasterize_wsi_labels(polys, (h, w), tile_size=args.tile_size,
                                      expansion_px=args.expansion_px, out=out)
    else:
        device = resolve_device(args.device)     # raises before any work without a card
        labels = segment_wsi(reader, lambda tile: hematoxylin_segment(tile, device),
                             args.tile_size, args.halo, dapi_channel=None)
        labels = expand_labels(labels, args.expansion_px)
    # the expansion is applied above (tiled, halo-consistent): the pyramid
    # writer only extracts the boundaries
    stream_labels_pyramid(labels, args.out_path, reader.mpp or 0.0, expansion_px=0.0)
    n = int(labels.max())
    reader.close()
    if args.polygons_json:
        del labels
        Path(scratch).unlink(missing_ok=True)
    print(f"{n} nuclei -> {args.out_path}")
    return n


if __name__ == "__main__":
    main()
