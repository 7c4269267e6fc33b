"""Streaming per-channel statistics -> channel_stats.json (the port's copy
of ``preprocessings/get_mean_std_channels.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.get_mean_std_channels
      --tile_dataframe T.csv --channel_names A,B,... --out_json J [--max_tiles 0]

Running f64 sums, sums of squares, minima and maxima per mIF channel and
over the H&E tiles' RGB, written as the channel-stats JSON the data layer
reads (``idx_channel, mean, std, min, max, is_structural``). Host only
(numpy, the JAX script's arithmetic).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.table import Table
from ..slideio import read_image


class RunningStats:
    def __init__(self, n_channels: int):
        self.n = 0
        self.sum = np.zeros(n_channels, np.float64)
        self.sumsq = np.zeros(n_channels, np.float64)
        self.min = np.full(n_channels, np.inf)
        self.max = np.full(n_channels, -np.inf)

    def update(self, tile_hwc: np.ndarray):
        flat = tile_hwc.reshape(-1, tile_hwc.shape[-1]).astype(np.float64)
        self.n += flat.shape[0]
        self.sum += flat.sum(axis=0)
        self.sumsq += (flat ** 2).sum(axis=0)
        self.min = np.minimum(self.min, flat.min(axis=0))
        self.max = np.maximum(self.max, flat.max(axis=0))

    def finalize(self):
        mean = self.sum / max(self.n, 1)
        var = self.sumsq / max(self.n, 1) - mean ** 2
        return mean, np.sqrt(np.maximum(var, 0)), self.min, self.max


def compute_channel_stats(dataframe: Table, channel_names, max_tiles: int = 0) -> dict:
    rows = (dataframe if not max_tiles
            else dataframe.take(np.arange(min(max_tiles, len(dataframe)))))
    rgb_stats = RunningStats(3)
    if_stats = None
    for i in range(len(rows)):
        row = rows.row(i)
        rgb_stats.update(read_image(row["image_path"]))
        mif = read_image(row["target_path"])
        if if_stats is None:
            if_stats = RunningStats(mif.shape[-1])
        if_stats.update(mif)

    mean, std, mn, mx = rgb_stats.finalize()
    out = {"RGB": {"mean": mean.tolist(), "std": std.tolist()}}
    imean, istd, imin, imax = if_stats.finalize()
    for idx, name in enumerate(channel_names):
        out[name] = {
            "idx_channel": idx,
            "mean": float(imean[idx]),
            "std": float(istd[idx]),
            "min": float(imin[idx]),
            "max": float(imax[idx]),
            "is_structural": False,
        }
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tile_dataframe", required=True)
    parser.add_argument("--channel_names", required=True,
                        help="comma-separated marker names in channel order")
    parser.add_argument("--out_json", required=True)
    parser.add_argument("--max_tiles", type=int, default=0)
    args = parser.parse_args(argv)

    stats = compute_channel_stats(Table.read_csv(args.tile_dataframe),
                                  args.channel_names.split(","), args.max_tiles)
    Path(args.out_json).write_text(json.dumps(stats, indent=2))
    print(f"channel stats -> {args.out_json}")


if __name__ == "__main__":
    main()
