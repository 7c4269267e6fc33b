"""Single-cell expression matrix from mIF and nuclei label WSIs, pooled on
the card (the port's copy of
``preprocessings/single_cell_analysis/extract_expression_matrix.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.single_cell_analysis.extract_expression_matrix
      --slide_dataframe T.csv --out_dir D [--tile_size 8192] [--device cpu]

The slide is walked in ``tile_size`` tile pairs. Each tile's labels and
channels are uploaded (uint16 and int32, through pinned memory), and on
the device ``torch.unique`` finds its labels, ``bincount`` their areas and
``index_add_`` in f64 their centroid and intensity sums, four channels at
a time (all 16 channels of an 8192^2 tile's nuclei pixels would take
gigabytes in f64 at once). The tiles' sums are merged by label on the
device the same way. Integer intensities and coordinates sum exactly in f64 in any
order, so the CSV (``label, area, centroid-0, centroid-1,
mean_intensity-{c}``, one row a label in ascending order) equals the JAX
script's bit for bit. Runs on the card unless ``--device cpu`` is given;
without a card it raises. ``main`` prints each slide's nuclei/s and Mpx/s
and the read / upload / device / write seconds.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..._device import resolve_device
from ...data.table import Table
from ...slideio import SlideReader
from ..stages import StageClock

CHANNEL_GROUP = 4          # channels gathered and summed in f64 at a time


def accumulate_tile(nuclei: torch.Tensor, mif: torch.Tensor, origin=(0, 0)):
    """Per-label sums of one tile on its device: ``(labels [n] int64,
    area [n] int64, sums [n, C] f64, centroid sums [n, 2] f64 (y, x))``,
    labels ascending, 0 (background) left out."""
    h, w = nuclei.shape
    n_ch = mif.shape[-1]
    flat = nuclei.reshape(-1).to(torch.int64)
    pos = torch.nonzero(flat > 0).squeeze(1)
    labels, inv = torch.unique(flat[pos], return_inverse=True)
    n = labels.numel()
    area = torch.bincount(inv, minlength=n)

    def pooled(vals: torch.Tensor) -> torch.Tensor:
        return torch.zeros((n,) + vals.shape[1:], dtype=torch.float64,
                           device=vals.device).index_add_(0, inv, vals.double())

    cent = pooled(torch.stack([pos // w + origin[1], pos % w + origin[0]], 1))
    groups = [torch.zeros((n, 0), dtype=torch.float64, device=nuclei.device)]
    for c0 in range(0, n_ch, CHANNEL_GROUP):
        group = mif[..., c0:c0 + CHANNEL_GROUP]
        # gathered as int32 (or f64): the index kernels need not take uint16
        group = group.double() if group.is_floating_point() else group.to(torch.int32)
        groups.append(pooled(group.reshape(h * w, -1)[pos]))
    return labels, area, torch.cat(groups, 1), cent


def merge_tiles(parts):
    """The tiles' ``accumulate_tile`` results summed by label, labels
    ascending (a nucleus cut by a tile edge is one row)."""
    labels = torch.cat([p[0] for p in parts])
    uniq, inv = torch.unique(labels, return_inverse=True)
    n = uniq.numel()
    out = [uniq]
    for i in (1, 2, 3):
        cat = torch.cat([p[i] for p in parts])
        out.append(torch.zeros((n,) + cat.shape[1:], dtype=cat.dtype,
                               device=cat.device).index_add_(0, inv, cat))
    return out


def expression_table(labels: np.ndarray, area: np.ndarray, sums: np.ndarray,
                     cent: np.ndarray) -> Table:
    """The CSV's columns from the merged sums (f64 division on the host,
    as the JAX script divides)."""
    if not len(labels):
        return Table({})
    cols = {"label": labels, "area": area, "centroid-0": cent[:, 0] / area,
            "centroid-1": cent[:, 1] / area}
    for c in range(sums.shape[1]):
        cols[f"mean_intensity-{c}"] = sums[:, c] / area
    return Table(cols)


def extract_expression_matrix(mif_path: str, nuclei_path: str, tile_size: int = 8192,
                              device=None, clock: StageClock = None) -> Table:
    device = resolve_device(device)
    clock = clock or StageClock(device)
    mif = SlideReader(mif_path, mode="IF")
    nuc = SlideReader(nuclei_path, channel_idxs=[0], mode="IF")
    w, h = mif.dimensions
    parts = []
    for ty in range(0, h, tile_size):
        for tx in range(0, w, tile_size):
            size = (min(tile_size, w - tx), min(tile_size, h - ty))
            with clock.stage("read"):
                labels = nuc.read_region((tx, ty), 0, size)[..., 0]
                values = mif.read_region((tx, ty), 0, size)
            labels, values = clock.upload(labels), clock.upload(values)
            with clock.stage("device"):
                part = accumulate_tile(labels, values, origin=(tx, ty))
                if part[0].numel():
                    parts.append(part)
    mif.close()
    nuc.close()
    with clock.stage("device"):
        if not parts:
            return Table({})
        merged = [t.cpu().numpy() for t in merge_tiles(parts)]
    return expression_table(*merged)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_dataframe", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--tile_size", type=int, default=8192)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    slide_df = Table.read_csv(args.slide_dataframe)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stats = []
    for i in range(len(slide_df)):
        row = slide_df.row(i)
        clock = StageClock(device)
        t0 = time.perf_counter()
        df = extract_expression_matrix(row["targ_slide_path"], row["nuclei_slide_path"],
                                       args.tile_size, device=device, clock=clock)
        out = out_dir / f"{row['in_slide_name']}_cells.csv"
        with clock.stage("write"):
            df.to_csv(out)
        wall = time.perf_counter() - t0
        reader = SlideReader(row["targ_slide_path"], mode="IF")
        mpx = reader.dimensions[0] * reader.dimensions[1] / 1e6
        reader.close()
        print(f"{row['in_slide_name']}: {len(df)} cells -> {out} in {wall:.3f} s on {device} "
              f"({len(df) / wall:.0f} nuclei/s, {mpx / wall:.2f} Mpx/s; {clock.text()})")
        stats.append({"slide": row["in_slide_name"], "cells": len(df), "wall_s": wall,
                      "nuclei_per_s": len(df) / wall, "mpx_per_s": mpx / wall,
                      "split": dict(clock.seconds), "csv": str(out)})
    return stats


if __name__ == "__main__":
    main()
