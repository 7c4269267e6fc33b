"""Cell-level losses (reference: src/loss.py:153-227).

The port's counterpart of ``mipheivit_tpu/train/cell_loss.py``. The loss is
the per-nucleus-mean MSE times ``lambda_factor`` plus, optionally, the
clustering term: a frozen 3-layer MLP gating classifier (``ClusterMLP``,
shipped as the reference's torch checkpoint ``mlp.ckpt``) run on the
unnormalised per-cell means, with a focal loss pulling the predicted cells'
soft labels toward the target cells' pseudo-labels. The target branch is
detached. The per-nucleus means come from ``ops.segment_pool``, whose
pooling makes no host sync, so the loss runs inside the training step
without stalling it. Over data-parallel ranks (``group``), the sums and
counts behind each mean are summed over the group first, so that every
rank's loss is the global batch's, as the JAX step computes it over a
sharded batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.segment_pool import segment_mean_pool
from ..parallel.mesh import all_reduce_sum


class Normalization(nn.Module):
    """``(x - mean) / std`` with fixed statistics (the reference's
    ``NormalizationLayer``)."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(n_channels))
        self.register_buffer("std", torch.ones(n_channels))

    def forward(self, x):
        return (x - self.mean) / self.std


class ClusterMLP(nn.Module):
    """Normalisation -> Linear/ReLU x2 -> Linear -> sigmoid (reference:
    src/loss.py:185-193); its state dict has the reference's key layout,
    ``model.{0,1,3,5}.*``."""

    def __init__(self, n_channels: int, hidden1: int, hidden2: int, n_out: int):
        super().__init__()
        self.model = nn.Sequential(Normalization(n_channels), nn.Linear(n_channels, hidden1),
                                   nn.ReLU(), nn.Linear(hidden1, hidden2), nn.ReLU(),
                                   nn.Linear(hidden2, n_out))

    def forward(self, x):
        return torch.sigmoid(self.model(x))


def load_cluster_mlp(mlp_path: str, n_channels: int, device=None) -> ClusterMLP:
    """The frozen MLP of a reference ``mlp.ckpt`` (a state dict, or a
    checkpoint holding one under ``state_dict``), in f32 and eval mode. The
    normalisation statistics default to 0 and 1 when the file has none."""
    obj = torch.load(mlp_path, map_location="cpu", weights_only=True)
    state = obj.get("state_dict", obj)
    state = {k[len("model."):] if k.startswith("model.") else k: v for k, v in state.items()}
    hidden1, hidden2 = state["1.weight"].shape[0], state["3.weight"].shape[0]
    mlp = ClusterMLP(n_channels, hidden1, hidden2, state["5.weight"].shape[0])
    mlp.model.load_state_dict({"0.mean": torch.zeros(n_channels), "0.std": torch.ones(n_channels),
                               **state})
    mlp.float().eval().requires_grad_(False)
    return mlp.to(device) if device is not None else mlp


def build_cell_loss(mlp_path: Optional[str], n_channels: int, use_mse: bool = True,
                    use_clustering: bool = True, lambda_factor: float = 50.0,
                    capacity: int = 1024, device=None, group=None) -> Callable:
    """Returns ``loss(pred [B,H,W,C], target [B,H,W,C], nuclei [B,H,W]) ->
    0-d f32 tensor``; the MLP is moved to ``device`` when given, else to
    the predictions' device at the first call. With ``group`` (the data
    ranks) the means are over the nuclei of every rank's rows."""
    mlp = None
    if use_clustering:
        if mlp_path is None:
            raise ValueError("clustering cell loss requires mlp_path")
        mlp = load_cluster_mlp(mlp_path, n_channels, device)
    eps = 1e-6

    def loss(pred, target, nuclei):
        zero = torch.zeros((), dtype=torch.float32, device=pred.device)
        if not (use_mse or use_clustering):
            return zero
        _, pred_means, valid = segment_mean_pool(pred, nuclei, capacity)
        _, targ_means, _ = segment_mean_pool(target.detach(), nuclei, capacity)
        w = valid.float()
        # numerators and counts of the MSE and the focal term, summed over
        # the data ranks when there are several
        parts = [zero, zero, zero, zero]
        if use_mse:
            parts[:2] = torch.sum(((pred_means - targ_means) ** 2).mean(-1) * w), w.sum()
        if use_clustering:
            if next(mlp.parameters()).device != pred.device:
                mlp.to(pred.device)
            pred_un = (pred_means + 0.9) / 1.8 * 255.0
            targ_un = (targ_means + 0.9) / 1.8 * 255.0
            p_in = torch.clamp(mlp(pred_un), eps, 1 - eps)
            with torch.no_grad():
                p_tg = torch.clamp(mlp(targ_un), eps, 1 - eps)
            labels = (p_tg > 0.5).float()
            # the focal loss on probabilities (the reference feeds the
            # probabilities as logits, src/loss.py:210; kept verbatim)
            s = torch.sigmoid(p_in)
            bce = -(labels * torch.log(s) + (1 - labels) * torch.log(1 - s))
            pt = torch.exp(-bce)
            fl = 0.5 * (1 - pt) ** 2 * bce
            mask = w[..., None]
            parts[2:] = torch.sum(fl * mask), mask.sum() * fl.shape[-1]
        sums = all_reduce_sum(torch.stack(parts), group)
        total = zero
        if use_mse:
            total = total + sums[0] / torch.clamp(sums[1], min=1.0) * lambda_factor
        if use_clustering:
            total = total + sums[2] / torch.clamp(sums[3], min=1.0)
        return total

    return loss
