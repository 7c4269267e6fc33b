"""Per-nucleus pooling as fixed-capacity segment reductions (PyTorch).

The port's counterpart of ``mipheivit_tpu/ops/segment_pool.py``, with its
semantics kept exactly: ``jnp.unique(size=K, fill_value=0)`` per sample,
i.e. the K smallest distinct labels in ascending order, padding slots of id
0 and count 0 after them, and the pixels of labels past the K-th distinct
one dropped from the sums (``jax.ops.segment_sum`` drops out-of-range
segments). Background is the label-0 slot when label 0 occurs.

It is built without a host sync and with static shapes, because the cell
loss runs inside the training step: a per-sample ``torch.sort`` of the
flattened labels, the first occurrence of each value, a ``cumsum`` for its
rank, and ``index_add`` into ``K + 1`` slots per sample (the last one
collects the dropped labels and is cut off). ``torch.unique`` is not used:
on the card it syncs with the host and returns a shape that depends on the
data. The sums are accumulated in f64 and returned in f32 whatever the
input's dtype: the card's atomic adds take the pixels in no fixed order,
and a 256-px tile's background slot sums ~50k of them, where f32
accumulation alone leaves ~1e-5 of the sum to the order (the JAX package
sums in f32). ``segment_mean_pool`` differentiates through autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _slots(labels: torch.Tensor, capacity: int):
    """``(ids [B, K], slot [B, N])``: the K smallest distinct labels of each
    sample (0-padded) and each pixel's slot in ``[0, K]``, K where the label
    is past the K-th distinct one."""
    b = labels.shape[0]
    flat = labels.reshape(b, -1)
    ordered, order = torch.sort(flat, dim=1, stable=True)
    first = torch.ones_like(ordered, dtype=torch.bool)
    first[:, 1:] = ordered[:, 1:] != ordered[:, :-1]
    rank = torch.cumsum(first, dim=1) - 1                 # the value's rank, per sorted pixel
    rank = torch.clamp(rank, max=capacity)               # K: past the capacity
    slot = torch.empty_like(rank).scatter_(1, order, rank)
    ids = torch.zeros(b, capacity + 1, dtype=flat.dtype, device=flat.device)
    # every pixel of a value writes the same id into its slot
    ids.scatter_(1, rank, ordered)
    return ids[:, :capacity], slot


def nucleus_pool(values: torch.Tensor, labels: torch.Tensor, capacity: int = 1024
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(sample, nucleus) channel sums and pixel counts.

    values ``[B, H, W, C]``, labels ``[B, H, W]`` integer nucleus ids (0 =
    background). Returns ``(ids [B, K], sums [B, K, C] f32, counts [B, K]
    f32)``; slots with count 0 are padding, the slot whose id is 0 (if
    present) is background. ``K = capacity``."""
    b, c = values.shape[0], values.shape[-1]
    ids, slot = _slots(labels, capacity)
    n = slot.shape[1]
    # one flat index per pixel into [B * (K + 1)] rows
    index = (slot + torch.arange(b, device=slot.device)[:, None] * (capacity + 1)).reshape(-1)
    flat_vals = values.reshape(b * n, c).double()
    sums = torch.zeros(b * (capacity + 1), c, dtype=torch.float64, device=values.device)
    sums = sums.index_add(0, index, flat_vals).float()
    counts = torch.zeros(b * (capacity + 1), dtype=torch.float32, device=values.device)
    counts = counts.index_add(0, index, torch.ones_like(index, dtype=torch.float32))
    sums = sums.reshape(b, capacity + 1, c)[:, :capacity]
    counts = counts.reshape(b, capacity + 1)[:, :capacity]
    return ids, sums, counts


def segment_mean_pool(values: torch.Tensor, labels: torch.Tensor, capacity: int = 1024):
    """Per-nucleus means (the reference's ``MeanCellExtrator``): returns
    ``(ids [B, K], means [B, K, C], valid [B, K])``, where ``valid``
    excludes background and padding."""
    ids, sums, counts = nucleus_pool(values, labels, capacity)
    means = sums / torch.clamp(counts[..., None], min=1.0)
    valid = (counts > 0) & (ids > 0)
    return ids, means, valid
