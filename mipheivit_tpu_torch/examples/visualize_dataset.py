"""Dataset contact sheet: H&E | per-marker mIF tiles as one PNG (the port's
copy of ``examples/visualize_dataset.py``).

Usage:
  python -m mipheivit_tpu_torch.examples.visualize_dataset --tile_dataframe T.csv
      --out_png G.png [--n_tiles 4] [--seed 0]

Draws ``--n_tiles`` rows of the tile dataframe with
``default_rng(seed).choice`` and writes them through ``utils.save_image_grid``
(the port's PNG encoder: no cv2). Host only.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.table import Table
from ..slideio import read_image
from ..utils import save_image_grid


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tile_dataframe", required=True)
    parser.add_argument("--out_png", required=True)
    parser.add_argument("--n_tiles", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    df = Table.read_csv(args.tile_dataframe)
    rng = np.random.default_rng(args.seed)
    rows = df.take(rng.choice(len(df), size=min(args.n_tiles, len(df)), replace=False))
    hes, mifs = [], []
    for i in range(len(rows)):
        row = rows.row(i)
        hes.append(read_image(row["image_path"]))
        mif = read_image(row["target_path"]).astype(np.float32)
        mifs.append(mif / 255.0 * 1.8 - 0.9)    # to the (-0.9, 0.9) codec
    save_image_grid(args.out_png, np.stack(hes), np.stack(mifs), max_images=args.n_tiles)
    print(f"grid -> {args.out_png}")


if __name__ == "__main__":
    main()
