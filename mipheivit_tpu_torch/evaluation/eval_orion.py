"""ORION paper evaluation (reference: evaluation/eval_orion.py).

Usage:
  python -m mipheivit_tpu_torch.evaluation.eval_orion --checkpoint_dir D
      [--dataset_config_path P] [--batch_size 4] [--device cpu]

val + test tiles -> generator -> per-nucleus pooling -> cell table split by
slide -> logistic regression fitted on the val slides, scored on the test
slides (+ XGBoost when installed). Writes the checkpoint dir's artefacts:
``results_logreg.csv``, ``cell_dataframe.csv``, ``logreg.npz`` and
``logreg.pth`` (the reference's layout), and ``results_xgboost.csv`` with
``xgboost.pkl`` when xgboost is there. Runs on the card unless ``--device
cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..data.stats import get_effective_width_height
from ..data.table import Table
from .common import (DATA_CONFIGS, build_forward, load_eval_config, print_results,
                     read_tile_size, results_dataframe, run_cell_accumulation,
                     train_xgboost_or_none)

DATASET_CONFIG_PATH = str(DATA_CONFIGS / "orion.yaml")


def run(cfg: Config, checkpoint_dir: str, batch_size: int = 4, device=None,
        forward_builder=build_forward, he_norm=None) -> dict:
    """Evaluate ``checkpoint_dir``'s generator on ``cfg``'s val and test
    tiles and write the artefacts there; returns ``{"results", "logreg",
    "cell_dataframe"}``.
    ``forward_builder(cfg, checkpoint_dir, width, height, nc_out, device)``
    makes the forward (``common.build_forward``; the HEMIT-pipeline scripts
    pass theirs), ``he_norm`` overrides the input normalisation."""
    slide_df = Table.read_csv(cfg.data.slide_dataframe_path)
    val_df = Table.read_csv(cfg.data.val_dataframe_path)
    test_df = Table.read_csv(cfg.data.test_dataframe_path)
    dataframe = Table.concat([val_df, test_df])
    # target := image (the pooling reads the predictions only;
    # reference: eval_orion.py:147)
    dataframe = dataframe.replace("target_path", dataframe["image_path"])

    width, height = get_effective_width_height(*read_tile_size(dataframe), train=True)
    nc_out = len(cfg.data.targ_channel_names)
    fwd = forward_builder(cfg, checkpoint_dir, width, height, nc_out, device)

    cell_metrics = run_cell_accumulation(cfg, fwd, dataframe, slide_df, crop=min(256, width),
                                         batch_size=batch_size, he_norm=he_norm,
                                         device=device)
    cell_dataframe = cell_metrics.get_dataframe_cell_pred_target()
    cell_metrics.reset()

    val_cells = cell_dataframe.filter(cell_dataframe.isin("slide_name",
                                                          val_df.unique("in_slide_name")))
    test_cells = cell_dataframe.filter(cell_dataframe.isin("slide_name",
                                                           test_df.unique("in_slide_name")))
    results, logreg = cell_metrics.train_logistic_regression(val_cells, test_cells,
                                                             return_metrics=True)
    results_df = results_dataframe(results)

    out_dir = Path(checkpoint_dir)
    results_df.to_csv(out_dir / "results_logreg.csv")
    cell_dataframe.to_csv(out_dir / "cell_dataframe.csv")
    np.savez(out_dir / "logreg.npz", **logreg.state_dict())
    torch.save({"weight": torch.tensor(logreg.weight), "bias": torch.tensor(logreg.bias)},
               str(out_dir / "logreg.pth"))

    xgb_dict, xgb_results = train_xgboost_or_none(val_cells, test_cells, cell_metrics)
    if xgb_results is not None:
        xgb_results.to_csv(out_dir / "results_xgboost.csv")
        with open(out_dir / "xgboost.pkl", "wb") as f:
            pickle.dump(xgb_dict, f)

    print_results(results_df)
    print(f"mean AUC: {np.mean(results_df['ROC AUC']):.4f}")
    return {"results": results_df, "logreg": logreg, "cell_dataframe": cell_dataframe}


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
