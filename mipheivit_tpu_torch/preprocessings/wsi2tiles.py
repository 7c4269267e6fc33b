"""Export tiles from registered WSIs to per-tile files (the port's copy of
``preprocessings/wsi2tiles.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.wsi2tiles --slide_dataframe S.csv
      --tile_dataframe T.csv --out_dir D --out_csv O.csv [--he_format png|jpg]
      [--rescale_mpp 0]

H&E tiles to 8-bit image files (cv2), mIF tiles to multi-channel TIFFs,
nuclei labels to int32 TIFFs (nearest when rescaled), in a pool of reader
threads; writes the file-mode tile dataframe (``image_path, target_path,
in_slide_name[, nuclei_path]``) the training data layer reads. Unlike the
JAX script, ``--rescale_mpp`` takes mIF slides of more than 4 channels at
a fractional scale (``slideio.resize``). Host only.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..data.table import Table
from ..slideio import SlideReader, resize, write_pyramid


def export_tiles(slide_row: dict, tile_df: Table, out_dir: Path, he_format: str = "png",
                 rescale_mpp: float = 0.0, num_workers: int = 4) -> Table:
    import cv2

    name = slide_row["in_slide_name"]
    he = SlideReader(slide_row["in_slide_path"], mode="RGB")
    mif = SlideReader(slide_row["targ_slide_path"], mode="IF")
    nuc = None
    if slide_row.get("nuclei_slide_path"):
        nuc = SlideReader(slide_row["nuclei_slide_path"], channel_idxs=[0], mode="IF")
    (out_dir / "he").mkdir(parents=True, exist_ok=True)
    (out_dir / "mif").mkdir(exist_ok=True)
    if nuc is not None:
        (out_dir / "nuclei").mkdir(exist_ok=True)

    scale = 1.0
    if rescale_mpp and he.mpp:
        scale = he.mpp / rescale_mpp

    def one(row):
        loc = (int(row["x"]), int(row["y"]))
        size = (int(row["tile_size_x"]), int(row["tile_size_y"]))
        level = int(row["level"])
        tile_name = "_".join(map(str, [name, *loc, level, *size]))
        he_tile = he.read_region(loc, level, size)
        mif_tile = mif.read_region(loc, level, size)
        if scale != 1.0:
            new = (int(size[0] * scale), int(size[1] * scale))
            he_tile = resize(he_tile, new, cv2.INTER_AREA)
            mif_tile = resize(mif_tile, new, cv2.INTER_AREA)
        he_path = out_dir / "he" / f"{tile_name}.{he_format}"
        cv2.imwrite(str(he_path), cv2.cvtColor(he_tile, cv2.COLOR_RGB2BGR))
        mif_path = out_dir / "mif" / f"{tile_name}.tiff"
        write_pyramid(str(mif_path), np.moveaxis(mif_tile, -1, 0), n_levels=1,
                      tile_size=min(512, size[0]))
        rec = {"image_path": str(he_path), "target_path": str(mif_path), "in_slide_name": name}
        if nuc is not None:
            nuc_tile = nuc.read_region(loc, level, size)[..., 0]
            if scale != 1.0:
                nuc_tile = cv2.resize(nuc_tile, new, interpolation=cv2.INTER_NEAREST)
            nuc_path = out_dir / "nuclei" / f"{tile_name}.tiff"
            write_pyramid(str(nuc_path), np.int32(nuc_tile)[None], n_levels=1,
                          tile_size=min(512, size[0]))
            rec["nuclei_path"] = str(nuc_path)
        return rec

    rows = tile_df.filter(tile_df["in_slide_name"] == name)
    with ThreadPoolExecutor(num_workers) as pool:
        records = list(pool.map(one, [rows.row(i) for i in range(len(rows))]))
    he.close()
    mif.close()
    return Table.from_records(records)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_dataframe", required=True)
    parser.add_argument("--tile_dataframe", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--out_csv", required=True)
    parser.add_argument("--he_format", default="png", choices=["png", "jpg"])
    parser.add_argument("--rescale_mpp", type=float, default=0.0)
    args = parser.parse_args(argv)

    slide_df = Table.read_csv(args.slide_dataframe)
    tile_df = Table.read_csv(args.tile_dataframe)
    frames = [export_tiles(slide_df.row(i), tile_df, Path(args.out_dir), args.he_format,
                           args.rescale_mpp)
              for i in range(len(slide_df))]
    Table.concat(frames).to_csv(args.out_csv)
    print(f"exported tiles -> {args.out_csv}")


if __name__ == "__main__":
    main()
