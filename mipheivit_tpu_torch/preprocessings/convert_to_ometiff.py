"""Convert any (multi-page or tiled) TIFF into a tiled pyramidal OME-TIFF
(the port's copy of ``preprocessings/convert_to_ometiff.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.convert_to_ometiff --input I
      --output O [--channel_names A,B,...] [--n_levels 5] [--tile_size 512]
      [--mpp 0] [--band_rows 2048]

Streamed in full-width row bands: one band is resident whatever the
slide's size. Unlike the JAX script, it takes single-channel slides (read
in ``IF`` mode, not widened to RGB). Host only.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..slideio import PyramidWriter, SlideReader, build_ome_xml


def convert(input_path: str, output_path: str, channel_names=None, n_levels: int = 5,
            tile_size: int = 512, mpp: float = 0.0, band_rows: int = 2048) -> None:
    reader = SlideReader(input_path, mode="IF")
    w, h = reader.dimensions
    names = (list(channel_names) if channel_names
             else [f"ch{i}" for i in range(reader.n_channels)])
    mpp = mpp or reader.mpp or 0.0
    xml = build_ome_xml(w, h, names, reader.dtype.name, physical_size_um=mpp or None)
    with PyramidWriter(output_path, width=w, height=h, n_channels=reader.n_channels,
                       dtype=reader.dtype, n_levels=n_levels, tile_size=tile_size, mpp=mpp,
                       ome_xml=xml) as writer:
        for ty in range(0, h, band_rows):
            bh = min(band_rows, h - ty)
            band = reader.read_region((0, ty), 0, (w, bh))
            writer.write_band(np.moveaxis(band, -1, 0))
    reader.close()
    print(f"{input_path} -> {output_path} ({reader.n_channels} channels, {n_levels} levels)")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--channel_names", default=None,
                        help="comma-separated; defaults to ch0..chN")
    parser.add_argument("--n_levels", type=int, default=5)
    parser.add_argument("--tile_size", type=int, default=512)
    parser.add_argument("--mpp", type=float, default=0.0)
    parser.add_argument("--band_rows", type=int, default=2048)
    args = parser.parse_args(argv)
    convert(args.input, args.output,
            args.channel_names.split(",") if args.channel_names else None,
            args.n_levels, args.tile_size, args.mpp, args.band_rows)


if __name__ == "__main__":
    main()
