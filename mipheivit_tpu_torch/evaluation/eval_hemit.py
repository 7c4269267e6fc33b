"""HEMIT benchmark evaluation (reference: evaluation/eval_hemit.py).

Usage:
  python -m mipheivit_tpu_torch.evaluation.eval_hemit --checkpoint_dir D
      [--dataset_config_path P] [--batch_size 4] [--device cpu]

Unlike eval_orion, the forward runs at 20x: each tile is downsampled 2x
(bilinear) before the generator and its prediction upsampled back
(reference lines 157-166, 216-219); and the logistic regression (and
XGBoost, when installed) is fitted on a 5 % sample of the train slides'
cells (lines 237-243), one fit scored on the val cells and one on the test
cells. Writes ``hemit_results_logreg_{val,test}.csv`` (and
``hemit_results_xgboost_{val,test}.csv``) and ``hemit_cell_dataframe.csv``.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import Config
from ..data.stats import get_effective_width_height
from ..data.table import Table
from .common import (DATA_CONFIGS, build_forward, load_eval_config, print_results,
                     read_tile_size, results_dataframe, run_cell_accumulation,
                     train_xgboost_or_none)

DATASET_CONFIG_PATH = str(DATA_CONFIGS / "hemit.yaml")


def run(cfg: Config, checkpoint_dir: str, batch_size: int = 4, device=None,
        forward_builder=build_forward, he_norm=None) -> dict:
    """Evaluate ``checkpoint_dir``'s generator on ``cfg``'s train, val and
    test tiles at half resolution; writes the CSVs there and returns
    ``{"val": results, "test": results, "cell_dataframe"}``.
    ``forward_builder(cfg, checkpoint_dir, width, height, nc_out, device)``
    makes the forward (``common.build_forward``; the HEMIT-pipeline scripts
    pass theirs), ``he_norm`` overrides the input normalisation."""
    slide_df = Table.read_csv(cfg.data.slide_dataframe_path)
    frames = {split: Table.read_csv(cfg.data[f"{split}_dataframe_path"])
              for split in ("train", "val", "test")}
    dataframe = Table.concat(list(frames.values()))
    dataframe = dataframe.replace("target_path", dataframe["image_path"])

    width, height = get_effective_width_height(*read_tile_size(dataframe), train=True)
    nc_out = len(cfg.data.targ_channel_names)
    # the model runs at half resolution (20x)
    fwd = forward_builder(cfg, checkpoint_dir, width // 2, height // 2, nc_out, device)

    cell_metrics = run_cell_accumulation(cfg, fwd, dataframe, slide_df, crop=width,
                                         batch_size=batch_size, scale_factor=0.5,
                                         he_norm=he_norm, device=device)
    cell_dataframe = cell_metrics.get_dataframe_cell_pred_target()
    cell_metrics.reset()

    def cells_of(split):
        return cell_dataframe.filter(cell_dataframe.isin(
            "slide_name", frames[split].unique("in_slide_name")))

    train_pool = cells_of("train")
    # a 5 % train-cell sample (reference: eval_hemit.py:237-243), at least a
    # handful of cells so that tiny datasets don't degenerate
    n_sample = max(int(len(train_pool) * 0.05), min(len(train_pool), 10))
    train_cells = train_pool.sample(n_sample, random_state=42)
    out_dir = Path(checkpoint_dir)
    out = {"cell_dataframe": cell_dataframe}
    for split in ("val", "test"):
        split_cells = cells_of(split)
        results, _ = cell_metrics.train_logistic_regression(train_cells, split_cells,
                                                            return_metrics=True)
        out[split] = results_dataframe(results)
        out[split].to_csv(out_dir / f"hemit_results_logreg_{split}.csv")
        _, xgb_results = train_xgboost_or_none(train_cells, split_cells, cell_metrics)
        if xgb_results is not None:
            xgb_results.to_csv(out_dir / f"hemit_results_xgboost_{split}.csv")
        print(split)
        print_results(out[split])
    cell_dataframe.to_csv(out_dir / "hemit_cell_dataframe.csv")
    return out


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
