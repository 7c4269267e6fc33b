"""ORION-style tile dataframes into HEMIT's pix2pix folder layout (the
port's copy of ``hemit/orion_to_hemit_layout.py``).

Usage:
  python -m mipheivit_tpu_torch.hemit.orion_to_hemit_layout --train_dataframe T
      --val_dataframe V --test_dataframe E --out_root R

Writes ``<root>/<split>/{input,label}/`` pairs, which
``mipheivit_tpu_torch.hemit.train_hemit`` and the original HEMIT codebase
read: the H&E tile copied, the mIF tile copied under the input's name, or
re-encoded as a TIFF under the input's stem where the suffixes differ.
Host only.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from ..data.table import Table
from ..slideio import read_image, write_pyramid


def convert(df: Table, split: str, out_root: Path, copy_targets: bool = True) -> int:
    in_dir = out_root / split / "input"
    lab_dir = out_root / split / "label"
    in_dir.mkdir(parents=True, exist_ok=True)
    lab_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(df)):
        row = df.row(i)
        src = Path(row["image_path"])
        shutil.copy2(src, in_dir / src.name)
        targ = Path(row["target_path"])
        if copy_targets and targ.suffix == src.suffix:
            shutil.copy2(targ, lab_dir / src.name)
        else:
            arr = read_image(str(targ))
            write_pyramid(str(lab_dir / (src.stem + ".tiff")), np.moveaxis(arr, -1, 0),
                          n_levels=1, tile_size=max(64, min(512, arr.shape[0])))
    return len(df)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_dataframe", required=True)
    parser.add_argument("--val_dataframe", required=True)
    parser.add_argument("--test_dataframe", required=True)
    parser.add_argument("--out_root", required=True)
    args = parser.parse_args(argv)

    out = Path(args.out_root)
    for split, path in (("train", args.train_dataframe), ("val", args.val_dataframe),
                        ("test", args.test_dataframe)):
        n = convert(Table.read_csv(path), split, out)
        print(f"{split}: {n} pairs -> {out / split}")


if __name__ == "__main__":
    main()
