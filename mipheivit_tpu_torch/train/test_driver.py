"""Eval-only driver (reference: src/test.py:30-152).

The port's counterpart of ``mipheivit_tpu/train/test_driver.py``: the
trainer's wiring around a finished checkpoint dir, running the val and test
epochs only and logging their pixel metrics to ``metrics.jsonl`` beside the
checkpoint. With ``train.use_cell_metrics`` and a slide dataframe it adds
the cell metrics: validation fits the logreg head, the test split is scored
with it and its cell table goes to ``<checkpoint_dir>/test_dataframe_cell.csv``
(reference: src/models.py:340-346). Runs on the card unless
``device="cpu"`` is given, the generator in bf16 there and f32 on the CPU.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..data.dataset import DataModule
from ..data.pipeline import device_prefetch
from ..data.stats import (Normalizer, get_effective_width_height, get_input_mean_std,
                          load_channel_stats)
from ..data.table import Table
from ..infer.loading import load_trainer_export
from ..metrics import PixelMetrics
from ..metrics.cell import METRIC_KEYS, CellMetrics
from ..utils import MetricsLogger
from .losses import build_reconstruction_loss
from .steps import StepConfig, TrainState, make_eval_step
from .trainer import check_foreground_head, get_width_height, refuse_unported, uses_cell_metrics

log = logging.getLogger(__name__)


def test_model(cfg, checkpoint_dir: str, run_name: str, dtype: Optional[str] = None,
               device=None) -> Dict:
    """Pixel metrics of ``checkpoint_dir``'s generator on the val and test
    splits of ``cfg``: ``{"val_psnr", "val_ssim", "val_gen_loss_sim",
    "test_...": ...}``, and with cell metrics ``{split}_cell_{auc,
    auc_logreg, balanced_acc, f1}``."""
    refuse_unported(cfg)
    check_foreground_head(cfg)
    device = resolve_device(device)
    if dtype is None:
        dtype = "bfloat16" if device.type == "cuda" else "float32"

    val_df = Table.read_csv(cfg.data.val_dataframe_path)
    test_df = Table.read_csv(cfg.data.test_dataframe_path)
    slide_df = (Table.read_csv(cfg.data.slide_dataframe_path)
                if cfg.data.slide_dataframe_path else None)
    channel_stats = load_channel_stats(cfg.data.channel_stats_path)
    from_slide = "image_path" not in test_df.columns

    width, height = get_width_height(test_df)
    width, height = get_effective_width_height(width, height, train=True)
    channel_names = list(cfg.data.targ_channel_names)
    nc_out = len(channel_names)
    encoder_name = cfg.select("model.encoder.encoder_name", "hoptimus0")

    he_norm = Normalizer(get_input_mean_std(cfg.model.model_name, encoder_name,
                                            channel_stats.rgb), mode="he")
    use_cell_metrics = uses_cell_metrics(cfg)
    dm = DataModule(
        slide_dataframe=slide_df, train_dataframe=val_df, val_dataframe=val_df,
        test_dataframe=test_df, targ_channel_idxs=channel_stats.channel_idxs(channel_names),
        batch_size=cfg.train.batch_size, input_shape=(width, height), from_slide=from_slide,
        return_nuclei=use_cell_metrics, preprocess_input_fn=he_norm,
        preprocess_target_fn=Normalizer(mode="if"))
    dm.setup()

    model = load_trainer_export(
        cfg.model.model_name, encoder_name, checkpoint_dir, (height, width), nc_out,
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32, device=device,
        encoder_ckpt_path=cfg.select("model.encoder.encoder_weights"),
        foreground_head=bool(cfg.select("train.foreground_head", False)))
    state = TrainState(step=0, generator=model, gen_params=[], gen_opt_state=None,
                       device=device)
    loss_fn = build_reconstruction_loss(cfg, channel_names, channel_stats,
                                        train_dataframe=val_df)
    eval_step = make_eval_step(model, loss_fn, StepConfig(
        foreground_head=bool(cfg.select("train.foreground_head", False))))

    cell_metrics = CellMetrics(slide_df, channel_names) if use_cell_metrics else None
    logger = MetricsLogger(checkpoint_dir, run_name=run_name, use_wandb=False)
    results: Dict = {}
    logreg_head = None
    for split in ("val", "test"):
        metrics = PixelMetrics.zeros(device)
        losses = []
        loader = dm.loader(split)
        loader.pad_to_batch = True
        for batch in device_prefetch(loader, size=2, device=device):
            b = {"image": batch["image"], "target": batch["target"], "mask": batch["mask"]}
            metrics, elog = eval_step(state, b, metrics)
            losses.append(elog["gen_loss_sim"])
            if cell_metrics is not None:
                n_valid = int(batch["mask"].sum())
                cell_metrics.update(elog["pred"][:n_valid], batch["nuclei"][:n_valid],
                                    batch["slide_name"][:n_valid])
        out = {f"{split}_{k}": float(v) for k, v in metrics.compute().items()}
        out[f"{split}_gen_loss_sim"] = (float(np.mean([float(v) for v in losses]))
                                        if losses else np.nan)
        if cell_metrics is not None:
            if split == "val":
                cm = cell_metrics.compute()
                logreg_head = cm["logreg_head"]
            else:
                cm, cell_df = cell_metrics.compute(logreg_head=logreg_head,
                                                   return_dataframe=True)
                cell_df.to_csv(Path(checkpoint_dir) / "test_dataframe_cell.csv")
            out.update({f"{split}_cell_{key}": float(cm[key]) for key in METRIC_KEYS})
        logger.log(out)
        results.update(out)
        log.info("%s: %s", split, {k: round(v, 4) for k, v in out.items()})
    logger.finish()
    return results
