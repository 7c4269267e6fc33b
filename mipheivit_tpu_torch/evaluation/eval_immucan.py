"""IMMUCAN external validation (reference: evaluation/eval_immucan.py).

Usage:
  python -m mipheivit_tpu_torch.evaluation.eval_immucan --checkpoint_dir D
      [--dataset_config_path P] [--batch_size 4] [--device cpu]

The tile-level Pearson correlation between the predicted-positive cell
counts (generator -> per-nucleus means -> the logreg gate of the ORION
checkpoint's ``logreg.npz`` or ``logreg.pth``) and the dataframe's
ground-truth ``{marker}_count`` columns, for CD3e, CD8a, CD4, FOXP3 and
Pan-CK. Writes ``immucan_corr.csv`` and ``immucan_tile_sums.csv``. Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..data.stats import get_effective_width_height
from ..data.table import Table
from ..metrics.cell import LogRegHead
from .common import (DATA_CONFIGS, build_forward, load_eval_config, read_tile_size,
                     run_cell_accumulation)

MARKERS = ("CD3e", "CD8a", "CD4", "FOXP3", "Pan-CK")
DATASET_CONFIG_PATH = str(DATA_CONFIGS / "immucan.yaml")


def load_logreg(checkpoint_dir: str) -> LogRegHead:
    npz = Path(checkpoint_dir) / "logreg.npz"
    if npz.exists():
        data = np.load(npz)
        return LogRegHead(weight=data["weight"], bias=data["bias"])
    pth = Path(checkpoint_dir) / "logreg.pth"
    if pth.exists():
        state = torch.load(str(pth), map_location="cpu", weights_only=True)
        return LogRegHead(weight=state["weight"].numpy(), bias=state["bias"].numpy())
    raise FileNotFoundError(f"no logreg.npz/logreg.pth in {checkpoint_dir}; run eval_orion first")


def run(cfg: Config, checkpoint_dir: str, batch_size: int = 4, device=None,
        forward_builder=build_forward, he_norm=None) -> dict:
    """Pool ``cfg``'s test tiles per tile, gate the cells and correlate the
    positive counts with the tiles' ground truth; writes the two CSVs to
    ``checkpoint_dir`` and returns ``{"corr", "tile_sums"}``.
    ``forward_builder(cfg, checkpoint_dir, width, height, nc_out, device)``
    makes the forward (``common.build_forward``; the HEMIT-pipeline scripts
    pass theirs), ``he_norm`` overrides the input normalisation."""
    from scipy.stats import pearsonr

    dataframe = Table.read_csv(cfg.data.test_dataframe_path)
    dataframe = dataframe.replace("target_path", dataframe["image_path"])
    # per-tile accumulation: the "slide" key is the tile name
    # (reference: eval_immucan.py:127-130)
    tile_names = np.empty(len(dataframe), object)
    tile_names[:] = [Path(p).stem for p in dataframe["image_path"]]
    slide_df = Table({"in_slide_name": tile_names,
                      "nuclei_csv_path": np.full(len(dataframe), None, object)})

    width, height = get_effective_width_height(*read_tile_size(dataframe), train=True)
    nc_out = len(cfg.data.targ_channel_names)
    fwd = forward_builder(cfg, checkpoint_dir, width, height, nc_out, device)
    logreg = load_logreg(checkpoint_dir)

    cell_metrics = run_cell_accumulation(cfg, fwd, dataframe, slide_df, crop=min(256, width),
                                         batch_size=batch_size, slide_key="tile_name",
                                         he_norm=he_norm, device=device)
    cell_dataframe = cell_metrics.get_dataframe_cell_pred().rename({"slide_name": "tile_name"})
    cell_metrics.reset()

    preds = np.stack([cell_dataframe[c] for c in cell_metrics.marker_pred_cols], axis=1)
    probs = logreg.predict_proba(preds.astype(np.float32))
    pred_columns = [f"{col}_logreg" for col in cell_metrics.marker_cols]
    for j, col in enumerate(pred_columns):
        cell_dataframe = cell_dataframe.replace(col, probs[:, j] > 0.5)

    tile_sums = cell_dataframe.groupby_sum("tile_name", pred_columns)
    dataframe = dataframe.replace("tile_name", tile_names)
    dataframe = dataframe.drop(["image_path", "nuclei_path", "target_path"])
    dataframe = dataframe.rename({"CD3_count": "CD3e_count", "CD8_count": "CD8a_count"})
    tile_sums = tile_sums.merge(dataframe, left_on=["tile_name"], right_on=["tile_name"],
                                how="inner")

    out_dir = Path(checkpoint_dir)
    rows = []
    for marker in MARKERS:
        truth_col, pred_col = f"{marker}_count", f"{marker}_pos_logreg"
        if truth_col not in tile_sums.columns or pred_col not in tile_sums.columns:
            continue
        corr, _ = pearsonr(tile_sums[truth_col], tile_sums[pred_col])
        rows.append([marker, float(corr)])
        print(f"{marker}: Pearson r = {corr:.3f}")
    corr_table = Table({"Marker": [r[0] for r in rows], "Pearson": [r[1] for r in rows]})
    corr_table.to_csv(out_dir / "immucan_corr.csv")
    tile_sums.to_csv(out_dir / "immucan_tile_sums.csv")
    return {"corr": corr_table, "tile_sums": tile_sums}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", type=str, required=True)
    parser.add_argument("--dataset_config_path", default=DATASET_CONFIG_PATH)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu to run on the CPU)")
    args = parser.parse_args(argv)
    cfg = load_eval_config(args.checkpoint_dir, args.dataset_config_path)
    return run(cfg, args.checkpoint_dir, args.batch_size, args.device)


if __name__ == "__main__":
    main()
