"""Rescale WSIs to a target resolution (default 0.245 mpp) as pyramidal
OME-TIFFs (the port's copy of ``scripts/scale_slides.py``).

Usage:
  python -m mipheivit_tpu_torch.scripts.scale_slides (--input S |
      --slide_dataframe_path T.csv) --out_dir D [--target_mpp 0.245]
      [--band_rows 1024] [--n_levels 5]

Band-streamed on the host: each output row band resamples only the input
rows it maps to (cv2 ``INTER_AREA`` to downscale, ``INTER_LINEAR`` to
upscale), so one full-width band is resident on each side. Unlike the
JAX script, it takes single-channel slides (read in ``IF`` mode, not
widened to RGB) and more than 4 channels at a fractional downscale
(``slideio.resize``). The slide dataframe is read with ``data.table`` (no
pandas).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.table import Table
from ..slideio import PyramidWriter, SlideReader, build_ome_xml, resize


def scale_slide(in_path: str, out_path: str, target_mpp: float = 0.245,
                band_rows: int = 1024, n_levels: int = 5,
                tile_size: int = 512) -> None:
    import cv2

    reader = SlideReader(in_path, mode="IF")
    if not reader.mpp:
        raise ValueError(f"{in_path} carries no mpp; cannot rescale")
    scale = reader.mpp / target_mpp
    w, h = reader.dimensions
    ow, oh = max(int(round(w * scale)), 1), max(int(round(h * scale)), 1)
    names = reader.channel_names or [f"ch{i}" for i in range(reader.n_channels)]
    xml = build_ome_xml(ow, oh, names, reader.dtype.name, physical_size_um=target_mpp)
    interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_LINEAR
    with PyramidWriter(out_path, width=ow, height=oh, n_channels=reader.n_channels,
                       dtype=reader.dtype, n_levels=n_levels, tile_size=tile_size,
                       mpp=target_mpp, ome_xml=xml) as writer:
        for oy in range(0, oh, band_rows):
            obh = min(band_rows, oh - oy)
            iy0 = int(np.floor(oy / scale))
            iy1 = min(int(np.ceil((oy + obh) / scale)), h)
            band = reader.read_region((0, iy0), 0, (w, iy1 - iy0))
            out = resize(band, (ow, obh), interp)
            if out.ndim == 2:
                out = out[..., None]
            writer.write_band(np.moveaxis(out, -1, 0))
    reader.close()
    print(f"{in_path} ({reader.mpp:.3f} mpp) -> {out_path} ({target_mpp} mpp, {ow}x{oh})")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_dataframe_path", default=None,
                        help="CSV with an in_slide_path column; or use --input")
    parser.add_argument("--input", default=None, help="single slide path")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--target_mpp", type=float, default=0.245)
    parser.add_argument("--band_rows", type=int, default=1024)
    parser.add_argument("--n_levels", type=int, default=5)
    args = parser.parse_args(argv)

    if args.input:
        paths = [args.input]
    elif args.slide_dataframe_path:
        paths = list(Table.read_csv(args.slide_dataframe_path)["in_slide_path"])
    else:
        raise SystemExit("pass --input or --slide_dataframe_path")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in paths:
        scale_slide(path, str(out_dir / Path(path).name), args.target_mpp,
                    args.band_rows, args.n_levels)


if __name__ == "__main__":
    main()
