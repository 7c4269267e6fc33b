"""Ranks, groups and data-parallel placement (PyTorch).

The port's counterpart of ``mipheivit_tpu/parallel/mesh.py``. The JAX
package runs one SPMD process over a ``Mesh`` and lets GSPMD insert the
collectives; the port runs one process per card, launched by
``python -m torch.distributed.run`` (torchrun), and calls the collectives
itself through ``torch.distributed``: NCCL between cards, gloo on the CPU
(and for ranks that share one card, where NCCL refuses to start).

- ``init_distributed`` starts the process group from torchrun's
  environment and picks the rank's card;
- ``make_mesh(n_data, n_model)`` builds the ``("data", "model")`` groups
  over the ranks: rank ``r`` sits at ``(r // n_model, r % n_model)``, so
  the ranks of one model group are consecutive;
- ``shard_batch`` keeps a rank's rows of a global batch;
- ``make_data_mesh`` is the in-process data parallelism of the JAX
  package's ``make_data_mesh``: one replica of the model per local device,
  the batch split across them (``LocalMesh``);
- ``average_gradients`` and ``all_reduce_sum`` are the collectives of the
  training step and of the BatchNorm statistics;
- ``copy_to_model`` and ``reduce_from_model`` are Megatron's pair around a
  tensor-parallel block (``parallel/sharding.py``); ``max_over_model`` and
  ``sum_int_over_model`` are the two reductions of its int8 row-split
  layers (the row scales' max, the int32 partial products' sum).

Nothing falls back: ``WORLD_SIZE > 1`` without a process group raises
(``require_process_group``), a rank whose card does not exist raises, and
two ranks share a card only when the caller names the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def world_size() -> int:
    """The process group's size, else torchrun's ``WORLD_SIZE`` (1 when
    unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def require_process_group() -> int:
    """The world size; raises ``RuntimeError`` when ``WORLD_SIZE`` asks for
    several processes and none has started (no silent single-process run
    under torchrun)."""
    n = world_size()
    if n > 1 and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"WORLD_SIZE={n} but no process group is running: launch through "
            "python -m torch.distributed.run (the CLIs start the group) or call "
            "mipheivit_tpu_torch.parallel.init_distributed() first")
    return n


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Start the process group from torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` (and ``MASTER_ADDR`` / ``MASTER_PORT`` unless
    ``init_method`` is given); returns this rank's device.

    The rank takes ``cuda:{LOCAL_RANK}`` unless ``device`` names one, and
    raises when that card does not exist or when there is no card at all
    (pass ``device="cpu"`` to run the ranks on the CPU). ``backend`` is NCCL
    on cards and gloo on the CPU unless given (two ranks on one card need
    ``backend="gloo"``: NCCL refuses a duplicate GPU). Calling it again in
    a process whose group is running returns the device it chose."""
    global _DEVICE
    if dist.is_initialized():
        if _DEVICE is None:
            raise RuntimeError("a process group is running that init_distributed did not start")
        return _DEVICE
    env_rank = int(os.environ.get("RANK", "0"))
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", str(env_rank)))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for this rank; pass device='cpu' "
                               "(--device cpu) to run the ranks on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card: this host shows "
                f"{torch.cuda.device_count()}; start at most that many ranks a host, or name "
                "the device to share a card")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=env_rank,
                            world_size=env_world)
    _DEVICE = device
    return device


_DEVICE: Optional[torch.device] = None


def process_device() -> Optional[torch.device]:
    """The device ``init_distributed`` chose for this rank (None before)."""
    return _DEVICE if dist.is_initialized() else None


@dataclasses.dataclass
class Mesh:
    """The ``("data", "model")`` layout of the ranks: this rank's
    coordinates and the process groups of its row and column. A group of
    one rank is None (its collectives are no-ops)."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object]
    model_group: Optional[object]

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``n_data x n_model`` mesh over every rank of the process group
    (``n_data`` defaults to the world size over ``n_model``). Every rank
    must call it, in the same order as its other group creations."""
    n = require_process_group()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} ranks")
    r = rank()
    data_group = model_group = None
    if n > 1:
        # every rank creates every group (torch.distributed's rule), and
        # keeps the two it belongs to
        for d in range(n_data):
            ranks = list(range(d * n_model, (d + 1) * n_model))
            group = dist.new_group(ranks) if n_model > 1 else None
            if r in ranks:
                model_group = group
        for m in range(n_model):
            ranks = list(range(m, n, n_model))
            group = dist.new_group(ranks) if n_data > 1 else None
            if r in ranks:
                data_group = group
    return Mesh(n_data=n_data, n_model=n_model, data_rank=r // n_model,
                model_rank=r % n_model, data_group=data_group, model_group=model_group)


def shard_batch(batch, mesh: Mesh):
    """The rows of a global batch (dict of arrays or tensors, leading axis
    the batch) that this rank's data coordinate holds: the contiguous
    ``1/n_data`` block, as the JAX package's batch sharding lays it out.
    Other fields pass through."""
    def rows(x):
        if not hasattr(x, "shape") or not getattr(x, "ndim", 0):
            return x
        n = x.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"batch of {n} rows does not split over {mesh.n_data} data ranks")
        step = n // mesh.n_data
        return x[mesh.data_rank * step:(mesh.data_rank + 1) * step]

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


# ---- in-process data parallelism -------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Local devices that each run a replica of the model on their slice of
    the batch (the JAX package's one-axis data mesh in one process)."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_data_mesh(batch_size: int, devices: Optional[Sequence] = None) -> Optional[LocalMesh]:
    """The largest count of ``devices`` (default: every local card) that
    divides ``batch_size``, as a ``LocalMesh``; None when only one device
    would be used."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n <= 1:
        return None
    return LocalMesh(tuple(devices[:n]))


def replicate(model: torch.nn.Module, mesh: LocalMesh) -> List[torch.nn.Module]:
    """One copy of ``model`` on each device of ``mesh``: the model itself,
    moved to the first device, and a deep copy on each of the others (a
    device named twice gets two copies)."""
    import copy

    model.to(mesh.devices[0])
    return [model] + [copy.deepcopy(model).to(d) for d in mesh.devices[1:]]


# ---- collectives of the training step ----------------------------------------

_BUCKET_ELEMENTS = 1 << 24          # 64 MiB of f32 per all_reduce


def average_gradients(grads: Sequence[torch.Tensor],
                      scales: Optional[Sequence[float]] = None, group=None) -> None:
    """In place: each gradient multiplied by its ``scale`` (1 if None),
    summed over the ranks of ``group`` (None: every rank) and divided by
    their count, in buckets of at most 64 MiB a collective, one collective
    per dtype and bucket. A scale of the group's size makes it a sum."""
    n = dist.get_world_size(group)
    if n == 1:
        return
    scales = [1.0] * len(grads) if scales is None else list(scales)
    by_dtype = {}
    for g, s in zip(grads, scales):
        by_dtype.setdefault((g.dtype, g.device), []).append((g, s))
    for items in by_dtype.values():
        buckets, current, size = [], [], 0
        for g, s in items:
            if current and size + g.numel() > _BUCKET_ELEMENTS:
                buckets.append(current)
                current, size = [], 0
            current.append((g, s))
            size += g.numel()
        buckets.append(current)
        for bucket in buckets:
            flat = torch.cat([(t * s if s != 1.0 else t).reshape(-1) for t, s in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            offset = 0
            for t, _ in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradients over the
    group too (every rank's loss depends on every rank's share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (x itself for a group of
    one rank)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the incoming
    gradients over the group (each rank's column shard contributes its
    part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the forward sums the partial outputs of a row-split
    layer over the group; the backward passes the gradient through (every
    rank's partial output enters the sum once, so its gradient is the
    sum's)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a tensor-parallel block's column-split layers: ``x``
    itself, its gradient summed over ``group`` (x itself for a group of one
    rank)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a tensor-parallel block's row-split layer: the sum of
    the ranks' partial ``x`` over ``group``, the gradient passed through
    (x itself for a group of one rank). Not ``all_reduce_sum``, whose
    backward sums too: here that would multiply every upstream gradient by
    the group's size."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group)


def max_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """In place and without autograd: the elementwise max of ``x`` (a small
    f32 tensor: an int8 row-split layer's per-row ``amax``) over ``group``;
    returns ``x`` (untouched for a group of one rank)."""
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def sum_int_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """In place and without autograd: the sum of the int32 ``x`` (an int8
    row-split layer's partial accumulator) over ``group``, exact as integer
    addition is; returns ``x`` (untouched for a group of one rank)."""
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x
