"""Per-channel mean and std of the training target tiles -> stats.json (the
port's copy of ``scripts/extract_std.py``).

Usage:
  python -m mipheivit_tpu_torch.scripts.extract_std --train_dataframe T.csv
      [--out stats.json]

f64 sums and sums of squares per channel over the /255-scaled targets,
rescaled back to 0-255: ``{"mean": [...], "std_channels": [...]}``. Host
only (numpy, the JAX script's arithmetic).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.table import Table
from ..slideio import read_image


def channel_moments(paths) -> dict:
    total = None
    total_sq = None
    n_pixels = 0
    for path in paths:
        img = read_image(str(path)).astype(np.float64) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        if total is None:
            total = np.zeros(img.shape[-1], np.float64)
            total_sq = np.zeros(img.shape[-1], np.float64)
        total += img.sum(axis=(0, 1))
        total_sq += (img ** 2).sum(axis=(0, 1))
        n_pixels += img.shape[0] * img.shape[1]
    mean = total / n_pixels
    std = np.sqrt(total_sq / n_pixels - mean ** 2)
    return {"mean": (mean * 255).tolist(), "std_channels": (std * 255).tolist()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_dataframe", required=True,
                        help="tile dataframe CSV with a target_path column")
    parser.add_argument("--out", default="stats.json")
    args = parser.parse_args(argv)

    df = Table.read_csv(args.train_dataframe)
    stats = channel_moments(df["target_path"])
    with open(args.out, "w") as f:
        json.dump(stats, f)
    print(f"{len(df)} tiles -> {args.out}")
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
