"""The tile dataframe of Otsu tissue tiling over WSIs (the port's copy of
``preprocessings/tiling.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.tiling --slide_dataframe S.csv
      --out_csv T.csv [--tile_size 256] [--overlap 0] [--mask_thresh 0.05]

For each slide of the slide dataframe: the tissue mask of a thumbnail, the
grid of level-0 tile positions over it, and one row a tile
(``in_slide_name, x, y, level, tile_size_x, tile_size_y, tissue_pct``).
Host only; the dataframes are ``data.table`` tables (no pandas).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.table import Table
from ..slideio import SlideReader, get_locs_otsu


def tile_slide(slide_path: str, tile_size: int, overlap: int = 0, mask_thresh: float = 0.05,
               level: int = 0, slide_name: str = None) -> Table:
    reader = SlideReader(slide_path, mode="RGB")
    thumb = reader.get_thumbnail((2048, 2048))
    ds = reader.level_downsample(level)
    locs, pcts = get_locs_otsu(thumb, reader.dimensions, tile_size * ds,
                               tile_overlap=overlap * ds, mask_thresh=mask_thresh)
    reader.close()
    name = slide_name or Path(slide_path).stem
    n = len(locs)
    return Table({
        "in_slide_name": np.full(n, name, object),
        "x": locs[:, 0], "y": locs[:, 1], "level": np.full(n, level, np.int64),
        "tile_size_x": np.full(n, tile_size, np.int64),
        "tile_size_y": np.full(n, tile_size, np.int64),
        "tissue_pct": np.asarray(pcts, np.float64),
    })


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_dataframe", required=True)
    parser.add_argument("--out_csv", required=True)
    parser.add_argument("--tile_size", type=int, default=256)
    parser.add_argument("--overlap", type=int, default=0)
    parser.add_argument("--mask_thresh", type=float, default=0.05)
    args = parser.parse_args(argv)

    slide_df = Table.read_csv(args.slide_dataframe)
    frames = []
    for i in range(len(slide_df)):
        row = slide_df.row(i)
        frames.append(tile_slide(row["in_slide_path"], args.tile_size, args.overlap,
                                 args.mask_thresh, slide_name=row.get("in_slide_name")))
    out = Table.concat(frames)
    out.to_csv(args.out_csv)
    print(f"{len(out)} tiles -> {args.out_csv}")


if __name__ == "__main__":
    main()
