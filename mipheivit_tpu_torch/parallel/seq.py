"""Sequence-sharded attention for whole-region encoding (PyTorch).

The port's counterpart of ``mipheivit_tpu/parallel/seq.py``. A 2048-px
region is 21 321 ViT-g tokens; sharding the token axis over the ranks of a
model group splits the query rows, while every rank attends over the full
key set: each block all-gathers its k | v columns (one collective a block)
and runs K4 (``ops.attention.flash_attention``) on its own query rows over
the gathered keys, with ``seq_len_k`` the true token count so that the
padding keys are masked. Everything token-local (LayerNorm, the MLP's K2,
the projections) runs on the shard alone.

The JAX package lets GSPMD shard the tokens around its ``shard_map``; here
the ViT does it itself (``models/vit.py``): every rank embeds the whole
region, keeps its token shard (``shard_tokens``) through the blocks, and
gathers the shards after the encoder (``gather_tokens``) for the decoder,
which every rank of the group then runs on the full grid.

The two gathers differ in their backward:

- the k | v gather's backward reduce-scatters dK | dV: every rank's
  queries touch every key, so each key's gradient is a sum over the ranks;
- the token gather feeds a computation that every rank of the group
  repeats identically, so its backward keeps the rank's own slice of the
  (identical) gradient and sums nothing.

The parameters that act on the shard (the encoder's) thus get partial
gradients, which the training step sums over the model group; the
decoder's are the same on every rank of the group
(``train/steps.py``).

The query shard reaches K4 even when it is 512 rows or fewer: K1 is square
only. Its backward is K5 with ``Sq != Sk``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.attention import flash_attention

# newer torch renames these two collectives *_single and deprecates the old
# names; older torch has only the old ones
all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                         or dist.reduce_scatter_tensor)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, s, C]`` on each of n ranks -> ``[B, n*s, C]``, rank order."""
    n = group_size(group)
    b, s, c = x.shape
    flat = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    all_gather_single(flat, x.contiguous().reshape(-1), group=group)
    return flat.view(n, b, s, c).transpose(0, 1).reshape(b, n * s, c)


def _reduce_scatter_tokens(g: torch.Tensor, group) -> torch.Tensor:
    """``[B, n*s, C]`` on each of n ranks -> this rank's ``[B, s, C]`` of
    the sum over the ranks."""
    n = group_size(group)
    b, sn, c = g.shape
    s = sn // n
    src = g.reshape(b, n, s, c).transpose(0, 1).contiguous().reshape(-1)
    out = torch.empty(b * s * c, dtype=g.dtype, device=g.device)
    reduce_scatter_single(out, src, group=group)
    return out.view(b, s, c)


class _GatherKV(torch.autograd.Function):
    """All-gather of the k | v shards; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, kv, group):
        ctx.group = group
        return _all_gather_tokens(kv, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_tokens(grad, ctx.group), None


class _GatherTokens(torch.autograd.Function):
    """All-gather of the token shards for a computation that every rank
    repeats; the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[1]
        return _all_gather_tokens(x, group)

    @staticmethod
    def backward(ctx, grad):
        r, s = group_rank(ctx.group), ctx.rows
        return grad[:, r * s:(r + 1) * s].contiguous(), None


def shard_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of ``x [B, S, C]``: S zero-padded to a multiple of
    the group's size (ViT-g's 5334 region tokens need the pad at 4 ranks),
    then the rank's contiguous block of ``ceil(S / n)`` rows."""
    n = group_size(group)
    if n == 1:
        return x
    s = x.shape[1]
    pad = (-s) % n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    rows = (s + pad) // n
    r = group_rank(group)
    return x[:, r * rows:(r + 1) * rows]


def gather_tokens(x: torch.Tensor, group, seq_len: int) -> torch.Tensor:
    """The shards ``[B, ceil(S/n), C]`` of every rank -> ``[B, S, C]`` (the
    padding rows dropped); its backward keeps the rank's own slice."""
    if group_size(group) == 1:
        return x
    return _GatherTokens.apply(x, group)[:, :seq_len]


def sharded_attention(q, k, v, num_heads: int, group, seq_len: int) -> torch.Tensor:
    """Attention of this rank's query rows ``q [B, s, H*D]`` over the keys
    of every rank: k | v ``[B, s, H*D]`` (each rank's shard) are gathered
    in one collective into ``[B, n*s, H*D]`` and K4 runs with
    ``seq_len_k = seq_len``, the true token count. Returns ``[B, s, H*D]``.
    Differentiable: K5 computes the rectangular backward and the gather's
    backward reduce-scatters dK | dV."""
    if group_size(group) > 1:
        hd = q.shape[-1]
        kv = _GatherKV.apply(torch.cat([k, v], dim=-1), group)
        k, v = kv[..., :hd], kv[..., hd:]
    return flash_attention(q, k, v, num_heads, seq_len_k=seq_len)[0]


def seq_sharded_attention(qkv_or_q, k=None, v=None, *, num_heads: int, group=None):
    """Attention over ``[B, S, H*D]`` tensors held whole on every rank of
    ``group`` (default: the enclosing ``seq_shard_scope``'s), computed with
    the token axis sharded over the group: fused qkv ``[B, S, 3*H*D]`` or
    separate q, k, v. S is zero-padded to a multiple of the group's size,
    each rank runs ``sharded_attention`` on its rows, and the outputs are
    gathered back to ``[B, S, H*D]`` on every rank. The gradient of an input
    on one rank holds the rows of that rank's shard (the others are 0): the
    sum over the group is the whole gradient."""
    if group is None:
        group = current_seq_scope()
    s = qkv_or_q.shape[1]
    if k is None:
        hd = qkv_or_q.shape[-1] // 3
        q, k, v = qkv_or_q[..., :hd], qkv_or_q[..., hd:2 * hd], qkv_or_q[..., 2 * hd:]
    else:
        q = qkv_or_q
    q, k, v = (shard_tokens(t, group) for t in (q, k, v))
    return gather_tokens(sharded_attention(q, k, v, num_heads, group, s), group, s)


_SEQ_CTX: list = []


class seq_shard_scope:
    """Routes ``ViTConfig.attn_impl="seq_shard"`` through the sequence
    sharding over ``mesh``'s model group (or a process group) for the
    dynamic extent of the scope. Every rank of the group enters it around
    the same forwards, in the same order::

        with seq_shard_scope(mesh):
            out = model(region)

    A backward needs no scope: the collectives keep their group."""

    def __init__(self, mesh_or_group):
        self.group = getattr(mesh_or_group, "model_group", mesh_or_group)

    def __enter__(self):
        _SEQ_CTX.append(self.group)
        return self

    def __exit__(self, *exc):
        _SEQ_CTX.pop()
        return False


def current_seq_scope():
    """The process group of the innermost ``seq_shard_scope``; raises
    ``RuntimeError`` outside every scope."""
    if not _SEQ_CTX:
        raise RuntimeError(
            'attn_impl="seq_shard" requires an enclosing seq_shard_scope(mesh) around the '
            "model's forward")
    return _SEQ_CTX[-1]

