"""Reconstruction / adversarial losses (PyTorch; reference: src/loss.py).

Counterpart of ``mipheivit_tpu/train/losses.py``: the same functions over
NHWC tensors, channel weights broadcast over the last axis, computed in the
dtype of the inputs (the generator's output is f32).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _weights(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32).reshape(-1), device=device)


def focal_l1_cubed_loss(lambda_factor: float, foreground_weight) -> Callable:
    """Per-channel-weighted |err|^3 (reference: src/loss.py:60-66); weights
    normalized to sum to 1."""
    w = np.asarray(foreground_weight, np.float32).reshape(-1)
    w = w / w.sum()

    def loss(y_true, y_pred):
        l1 = torch.abs(y_true - y_pred) ** 3
        return torch.mean(torch.sum(l1 * _weights(w, l1.device), dim=-1)) * lambda_factor

    return loss


def weighted_mse_loss(lambda_factor: float, marker_weights) -> Callable:
    """Channel-weighted MSE; weights = (1/std)/min(1/std)
    (reference: src/loss.py:47-57, src/train.py:137-142)."""

    def loss(y_true, y_pred):
        per_ch = torch.mean((y_true - y_pred) ** 2, dim=(0, 1, 2))
        return torch.mean(per_ch * _weights(marker_weights, per_ch.device)) * lambda_factor

    return loss


def marker_weights_from_stds(stds) -> np.ndarray:
    w = 1.0 / np.asarray(stds, np.float32)
    return w / w.min()


def mae_loss(lambda_factor: float) -> Callable:
    return lambda y_true, y_pred: torch.mean(torch.abs(y_true - y_pred)) * lambda_factor


def mse_loss(lambda_factor: float) -> Callable:
    return lambda y_true, y_pred: torch.mean((y_true - y_pred) ** 2) * lambda_factor


def weighted_mae_loss(sim_loss_factor: float, foreground_weight,
                      foreground_thresh) -> Callable:
    """Foreground-weighted L1 (reference: src/loss.py:21-32)."""

    def loss(y_true, y_pred):
        w = _weights(foreground_weight, y_true.device)
        thresh = _weights(foreground_thresh, y_true.device)
        weights = torch.where(y_true > thresh, w, torch.ones_like(w))
        return 2.0 * sim_loss_factor * torch.mean(torch.abs(y_pred - y_true) * weights)

    return loss


def shrinkage_loss(lambda_factor: float, foreground_weight) -> Callable:
    """Shrinkage loss (reference: src/loss.py:69-77)."""
    w = np.asarray(foreground_weight, np.float32).reshape(-1)
    wn = w / w.sum()

    def loss(y_true, y_pred):
        l = torch.abs(y_true - y_pred)
        val = l ** 2 / (1.0 + torch.exp(10.0 * (0.2 - l)))
        return torch.mean(torch.sum(val * _weights(wn, l.device), dim=-1)) * lambda_factor

    return loss


def l1_l2_loss(lambda_factor: float) -> Callable:
    """(L1 + L2)/2 * lambda (reference: src/loss.py:113-123)."""

    def loss(y_true, y_pred):
        l1 = torch.mean(torch.abs(y_pred - y_true))
        l2 = torch.mean((y_pred - y_true) ** 2)
        return lambda_factor * (l1 + l2) / 2.0

    return loss


def total_variation_loss(image) -> torch.Tensor:
    """TV regularizer over NHWC (reference: src/loss.py:104-110)."""
    tv_w = torch.mean(torch.abs(image[:, :, :-1] - image[:, :, 1:]))
    tv_h = torch.mean(torch.abs(image[:, :-1] - image[:, 1:]))
    return tv_w + tv_h


def sigmoid_bce(logits, labels):
    """Numerically-stable BCE-with-logits, elementwise (the JAX package's
    ``optax_sigmoid_bce``)."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def focal_bce_loss(alpha: float = 0.25, gamma: float = 2.0) -> Callable:
    """Binary focal loss on logits (reference: src/loss.py:8-18)."""

    def loss(logits, targets):
        bce = sigmoid_bce(logits, targets)
        pt = torch.exp(-bce)
        return torch.mean(alpha * (1.0 - pt) ** gamma * bce)

    return loss


def adversarial_loss(logits, targets, lsgan: bool = False) -> torch.Tensor:
    """BCE-with-logits (default) or LSGAN MSE (reference: src/models.py:81-85)."""
    if lsgan:
        return torch.mean((logits - targets) ** 2)
    return torch.mean(sigmoid_bce(logits, targets))


def get_foreground_weight(channel_names, train_dataframe) -> np.ndarray:
    """Channel weight = max(p_bg/p_fg, 1) from ``{m}_prop`` tile-dataframe
    columns (reference: src/utils.py:202-206)."""
    cols = [f"{name}_prop" for name in channel_names]
    p_fg = train_dataframe[cols].mean(axis=0).to_numpy(dtype=np.float64)
    fw = 1.0 - p_fg
    return np.maximum(fw / (1.0 - fw), 1.0)


def build_reconstruction_loss(cfg, channel_names, channel_stats,
                              train_dataframe=None) -> Callable:
    """Reference wiring (src/train.py:117-143): ``use_weighted_mae`` ->
    focal-L1^3 with foreground weights from the tile dataframe; otherwise
    weighted MSE with 1/std marker weights. ``channel_stats`` is a
    ``data.stats.ChannelStats``."""
    lam = cfg.train.losses.lambda_factor
    if cfg.train.losses.use_weighted_mae:
        if train_dataframe is None:
            raise ValueError("use_weighted_mae requires the train dataframe")
        fw = get_foreground_weight(channel_names, train_dataframe)
        return focal_l1_cubed_loss(lam, np.float32(fw))
    stds = channel_stats.stds(channel_names)
    return weighted_mse_loss(lam, marker_weights_from_stds(stds))
