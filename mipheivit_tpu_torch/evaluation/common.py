"""Shared plumbing of the evaluation scripts (reference: evaluation/*.py).

The port's counterpart of the JAX package's ``evaluation/common.py``: the
checkpoint dir's ``config.yaml`` with a dataset config's paths laid over
it, the generator's forward, the streaming per-nucleus accumulation of its
predictions (``metrics.cell.CellMetrics``), the results table and the
optional XGBoost gating. Each script's ``run(cfg, checkpoint_dir, ...)``
takes a ``Config``; only its ``main()`` reads YAML (PyYAML).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..config import Config, load_yaml
from ..data.augment import SpatialAugment
from ..data.dataset import TileImg2ImgDataset
from ..data.pipeline import Loader, device_prefetch
from ..data.stats import Normalizer, get_input_mean_std, load_channel_stats
from ..data.table import Table
from ..infer.loading import load_generator
from ..metrics import _gating
from ..metrics.cell import CellMetrics
from ..ops.resize import resize_bilinear

DATA_CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "data"
RESULT_COLUMNS = ["Marker", "ROC AUC", "Balanced Accuracy", "F1 Score"]
_DATA_KEYS = ("slide_dataframe_path", "train_dataframe_path", "val_dataframe_path",
              "test_dataframe_path", "channel_stats_path")


def load_eval_config(checkpoint_dir: str, dataset_config_path: Optional[str]) -> Config:
    """The run's ``config.yaml`` with the dataframe and channel-stats paths
    of the dataset config (its ``data`` group, or the file's top level)
    laid over ``data``, when that file exists."""
    cfg = load_yaml(Path(checkpoint_dir) / "config.yaml")
    if dataset_config_path and Path(dataset_config_path).exists():
        dataset = load_yaml(dataset_config_path)
        body = dataset.select("data", dataset)
        for key in _DATA_KEYS:
            if key in body:
                cfg.data[key] = body[key]
    return cfg


def build_forward(cfg: Config, checkpoint_dir: str, width: int, height: int, nc_out: int,
                  device=None):
    """The checkpoint's generator as ``x [B, H, W, 3] -> [B, H, W, C]``:
    ``load_generator`` with the fused marker heads, bf16 on the card, f32
    on the CPU."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = load_generator(
        cfg.model.model_name, cfg.select("model.encoder.encoder_name", "hoptimus0"),
        checkpoint_dir, (height, width), nc_out, dtype=dtype, device=device,
        encoder_ckpt_path=cfg.select("model.encoder.encoder_weights"))

    def fwd(x):
        with torch.inference_mode():
            return model(x)

    return fwd


def _scaled(fwd, scale_factor: float):
    """``fwd`` run at ``scale_factor`` of the input's size, the input and
    the prediction resized bilinearly (eval_hemit's 20x trick: reference
    evaluation/eval_hemit.py:157-166, 216-219)."""

    def scaled(x):
        h, w = x.shape[1], x.shape[2]
        xs = resize_bilinear(x.permute(0, 3, 1, 2), (int(h * scale_factor), int(w * scale_factor)))
        out = fwd(xs.permute(0, 2, 3, 1).contiguous())
        out = resize_bilinear(out.float().permute(0, 3, 1, 2), (h, w))
        return out.permute(0, 2, 3, 1)

    return scaled


def run_cell_accumulation(cfg: Config, fwd, dataframe: Table, slide_dataframe: Table,
                          crop: int = 256, batch_size: int = 4, scale_factor: float = 1.0,
                          slide_key: str = "slide_name", he_norm: Optional[Normalizer] = None,
                          device=None) -> CellMetrics:
    """Stream the tiles through ``fwd`` and pool per-nucleus statistics by
    ``slide_key`` (the tile name where the batch has none). ``scale_factor``
    < 1 runs the forward at that fraction of the size; ``he_norm``
    overrides the config's input normalisation."""
    device = resolve_device(device)
    if he_norm is None:
        channel_stats = load_channel_stats(cfg.data.channel_stats_path)
        he_norm = Normalizer(get_input_mean_std(
            cfg.model.model_name, cfg.select("model.encoder.encoder_name"), channel_stats.rgb),
            mode="he")
    dataset = TileImg2ImgDataset(dataframe, preprocess_input_fn=he_norm,
                                 spatial_augmentations=SpatialAugment(crop, crop, training=False),
                                 return_nuclei=True)
    loader = Loader(dataset, batch_size, shuffle=False, drop_last=False, num_workers=4,
                    pad_to_batch=True)
    cell_metrics = CellMetrics(slide_dataframe, marker_names=list(cfg.data.targ_channel_names),
                               min_area=20)
    if scale_factor != 1.0:
        fwd = _scaled(fwd, scale_factor)
    for batch in device_prefetch(loader, size=2, device=device):
        out = fwd(batch["image"])
        n = int(batch["mask"].sum())
        key = batch[slide_key] if slide_key in batch else batch["tile_name"]
        cell_metrics.update(out[:n], batch["nuclei"][:n], key[:n])
    return cell_metrics


def results_dataframe(results) -> Table:
    rows = list(results)
    return Table({name: [r[i] for r in rows] for i, name in enumerate(RESULT_COLUMNS)})


def print_results(results: Table) -> None:
    print("  ".join(RESULT_COLUMNS))
    for i in range(len(results)):
        row = results.row(i)
        print(f"{row['Marker']}  " + "  ".join(f"{row[c]:.6f}" for c in RESULT_COLUMNS[1:]))


def read_tile_size(dataframe: Table):
    """The first tile's (width, height)."""
    from ..slideio import read_image

    sample = read_image(dataframe["image_path"][0])
    return sample.shape[1], sample.shape[0]


def train_xgboost_or_none(train_df: Table, test_df: Table, cell_metrics: CellMetrics):
    """XGBoost gating classifiers, one per marker on the standardised cell
    means (reference: eval_orion.py:92-125); returns ``(model_dict,
    results)``, or ``(None, None)`` when xgboost cannot be imported."""
    try:
        from xgboost import XGBClassifier
    except ImportError:
        print("xgboost not available; skipping XGBoost gating "
              "(logreg results are still written)")
        return None, None

    def matrix(table, cols):
        return np.stack([table[c] for c in cols], axis=1)

    x_train = matrix(train_df, cell_metrics.marker_pred_cols).astype(np.float64)
    y_train = matrix(train_df, cell_metrics.marker_cols).astype(bool)
    x_test = matrix(test_df, cell_metrics.marker_pred_cols).astype(np.float64)
    y_test = matrix(test_df, cell_metrics.marker_cols).astype(bool)
    mean, scale = _gating.fit_scaler(x_train)
    xs, xs_test = (x_train - mean) / scale, (x_test - mean) / scale
    pos = max(int(y_train.sum()), 1)
    models, results = [], []
    for idx, marker in enumerate(cell_metrics.marker_cols):
        classes = np.unique(y_train[:, idx])
        if len(classes) == 1:      # OneVsRestClassifier's constant predictor
            models.append(bool(classes[0]))
            proba = np.full(len(xs_test), float(classes[0]))
        else:
            model = XGBClassifier(eval_metric="logloss",
                                  scale_pos_weight=(~y_train).sum() / pos, random_state=42)
            model.fit(xs, y_train[:, idx])
            models.append(model)
            proba = model.predict_proba(xs_test)[:, 1]
        pred = proba > 0.5
        results.append((marker, _gating.roc_auc(y_test[:, idx], proba),
                        _gating.balanced_accuracy(y_test[:, idx], pred),
                        _gating.f1(y_test[:, idx], pred)))
    return {"models": models, "scaler": (mean, scale)}, results_dataframe(results)
