"""Tile dataframe with per-marker statistics columns (the port's copy of
``scripts/create_dataframe.py``).

Usage:
  python -m mipheivit_tpu_torch.scripts.create_dataframe --tile_dataframe T.csv
      --slide_dataframe S.csv --channel_names A,B,... --out_csv O.csv

Adds ``{m}_count`` (gated positive cells of the slide's nuclei CSV whose
label lies in the tile) and ``{m}_prop`` (share of the tile's mIF pixels
above 1) columns, which the balanced sampler and the foreground weights
read. Host only; ``data.table`` tables (no pandas).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.table import Table
from ..slideio import read_image


def tile_marker_stats(tile_df: Table, slide_df: Table, channel_names,
                      if_threshold: float = 1.0) -> Table:
    """Adds {m}_count / {m}_prop columns. Counts come from the gated cell
    CSVs when nuclei tiles exist; props from thresholded mIF pixels."""
    cells = {}
    for i in range(len(slide_df)):
        row = slide_df.row(i)
        if row.get("nuclei_csv_path"):
            cells[row["in_slide_name"]] = Table.read_csv(row["nuclei_csv_path"])

    counts = {f"{m}_count": [] for m in channel_names}
    props = {f"{m}_prop": [] for m in channel_names}
    for i in range(len(tile_df)):
        row = tile_df.row(i)
        mif = read_image(row["target_path"])
        for idx, m in enumerate(channel_names):
            props[f"{m}_prop"].append(float((mif[..., idx] > if_threshold).mean()))
        if isinstance(row.get("nuclei_path"), str):
            nuc = read_image(row["nuclei_path"])[..., 0]
            labels = np.unique(nuc[nuc > 0])
            cell_df = cells.get(row.get("in_slide_name"))
            for m in channel_names:
                col = f"{m}_pos"
                if cell_df is not None and col in cell_df.columns:
                    vals = cell_df[col][np.isin(cell_df["label"], labels)]
                    pos = np.nansum(vals) if vals.dtype.kind == "f" else vals.sum()
                else:
                    pos = 0
                counts[f"{m}_count"].append(int(pos))
        else:
            for m in channel_names:
                counts[f"{m}_count"].append(0)
    out = tile_df
    for key, vals in {**counts, **props}.items():
        out = out.replace(key, vals)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tile_dataframe", required=True)
    parser.add_argument("--slide_dataframe", required=True)
    parser.add_argument("--channel_names", required=True)
    parser.add_argument("--out_csv", required=True)
    args = parser.parse_args(argv)

    out = tile_marker_stats(Table.read_csv(args.tile_dataframe),
                            Table.read_csv(args.slide_dataframe), args.channel_names.split(","))
    out.to_csv(args.out_csv)
    print(f"{len(out)} rows -> {args.out_csv}")


if __name__ == "__main__":
    main()
