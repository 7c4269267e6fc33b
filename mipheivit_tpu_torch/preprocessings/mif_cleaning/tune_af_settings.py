"""Headless AF-subtraction parameter sweep (the port's copy of
``preprocessings/mif_cleaning/tune_af_settings.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.mif_cleaning.tune_af_settings
      --slide_path S --out_json J [--af_channel 0] [--n_tiles 16]
      [--tile_size 1024] [--lambdas 0,0.1,0.25,0.5,0.75,1.0]

Sweeps lambda candidates on the slide's most tissue-covered tiles and keeps,
per channel, the lambda that minimises the residual correlation between the
cleaned channel and the AF channel, written as the lambda-settings JSON
that ``mif_cleaning --lambda_settings`` reads. Host only (numpy, f64).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ...slideio import SlideReader, get_locs_otsu


def residual_af_correlation(tiles, channel: int, af_channel: int, lam: float) -> float:
    cors = []
    for tile in tiles:
        ch = tile[..., channel].astype(np.float64).ravel()
        af = tile[..., af_channel].astype(np.float64).ravel()
        clean = np.maximum(ch - lam * af, 0)
        if clean.std() < 1e-9 or af.std() < 1e-9:
            continue
        cors.append(abs(np.corrcoef(clean, af)[0, 1]))
    return float(np.mean(cors)) if cors else 1.0


def tune(reader: SlideReader, af_channel: int, n_tiles: int, tile_size: int,
         lambdas) -> dict:
    """``{channel: {"lambda", "bias"}}`` for every channel but the AF one."""
    thumb = reader.get_thumbnail((1024, 1024))
    locs, pcts = get_locs_otsu(thumb, reader.dimensions, tile_size, mask_thresh=0.0)
    order = np.argsort(-pcts)[:n_tiles]
    tiles = [reader.read_region(tuple(locs[i]), 0, (tile_size, tile_size)) for i in order]
    settings = {}
    for c in range(reader.n_channels):
        if c == af_channel:
            continue
        scores = {lam: residual_af_correlation(tiles, c, af_channel, lam) for lam in lambdas}
        best = min(scores, key=scores.get)
        settings[str(c)] = {"lambda": best, "bias": 0.0}
        print(f"channel {c}: lambda={best} (residual AF corr {scores[best]:.3f})")
    return settings


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_path", required=True)
    parser.add_argument("--af_channel", type=int, default=0)
    parser.add_argument("--out_json", required=True)
    parser.add_argument("--n_tiles", type=int, default=16)
    parser.add_argument("--tile_size", type=int, default=1024)
    parser.add_argument("--lambdas", default="0,0.1,0.25,0.5,0.75,1.0")
    args = parser.parse_args(argv)

    reader = SlideReader(args.slide_path, mode="IF")
    settings = tune(reader, args.af_channel, args.n_tiles, args.tile_size,
                    [float(v) for v in args.lambdas.split(",")])
    Path(args.out_json).write_text(json.dumps(settings, indent=2))
    reader.close()
    print(f"settings -> {args.out_json}")


if __name__ == "__main__":
    main()
