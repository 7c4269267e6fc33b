"""Per-tile mIF artifact-channel statistics (the port's copy of
``preprocessings/artifacts_detection/extract_if_artifact_props.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.artifacts_detection.extract_if_artifact_props
      --tile_dataframe T.csv --artifact_channels 0,3 --out_csv O.csv [--thresh 200]

Per tile, the share of pixels above ``--thresh`` in each artifact channel,
as ``artifact_prop_ch{c}`` columns joined onto the tile dataframe. Host
only.
"""

from __future__ import annotations

import argparse

from ...data.table import Table
from ...slideio import read_image


def artifact_props(dataframe: Table, artifact_channels, thresh: float = 200.0) -> Table:
    cols = {c: [] for c in artifact_channels}
    for i in range(len(dataframe)):
        mif = read_image(dataframe.row(i)["target_path"])
        for c in artifact_channels:
            cols[c].append(float((mif[..., int(c)] > thresh).mean()))
    out = dataframe
    for c, vals in cols.items():
        out = out.replace(f"artifact_prop_ch{c}", vals)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tile_dataframe", required=True)
    parser.add_argument("--artifact_channels", required=True,
                        help="comma-separated channel indices")
    parser.add_argument("--thresh", type=float, default=200.0)
    parser.add_argument("--out_csv", required=True)
    args = parser.parse_args(argv)

    chans = [int(c) for c in args.artifact_channels.split(",")]
    artifact_props(Table.read_csv(args.tile_dataframe), chans, args.thresh).to_csv(args.out_csv)
    print(f"artifact props -> {args.out_csv}")


if __name__ == "__main__":
    main()
