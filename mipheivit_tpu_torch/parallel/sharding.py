"""Tensor parallelism for the ViT encoder (PyTorch).

The port's counterpart of ``mipheivit_tpu/parallel/sharding.py``. The JAX
package annotates the parameters with Megatron column and row splits over
the mesh's ``model`` axis and lets GSPMD insert the collectives; the port
holds each rank's slices in tensor-parallel twins of the blocks' ``attn``
and ``mlp`` and calls the collectives itself:

- ``encoder_param_specs(model)``: each parameter's class by the JAX rule
  (``"column"``: the qkv and fc1 weights and biases; ``"row"``: the proj
  and fc2 weights; None: the rest, the LoRA adapters, the norms, the layer
  scales, the proj and fc2 biases and the decoder among them);
- ``shard_params(model, mesh)``: every block's ``attn`` and ``mlp`` replaced
  by a ``ParallelAttention`` and a ``ParallelMlp`` that hold this rank's
  slices;
- ``shard_opt_state(opt_state, model, mesh)``: the optimizer moments of the
  trainable sharded tensors sliced the same way.

The layout is head-aligned where the JAX one is not. JAX splits the output
axis of the packed qkv kernel ``[q | k | v]`` into contiguous blocks (at 2
ranks, rank 0 holds all of q and half of k) and GSPMD reshards for the
attention. The port keeps attention local: rank r takes its heads' rows of
each section, packed ``[q_r | k_r | v_r]``, so that K1 (or K4 above 512
tokens) reads that buffer in place at ``num_heads / n`` heads. The packed
SwiGLU fc1 ``[a | g]`` is cut the same way, ``[a_r | g_r]``, so that K2
runs at hidden ``H / n``. The function computed is the JAX one; only which
rank holds which columns differs.

A block on rank r of a model group of n:

  attn: copy_to_model(x) -> qkv_r (LoRA live: + alpha x A B[:, heads_r])
        -> attention at H / n heads -> proj_r (its input columns)
        -> reduce_from_model -> + proj bias
  mlp:  copy_to_model(x) -> fc1_r (K2 at H / n, or GELU) -> fc2_r
        -> reduce_from_model -> + fc2 bias

``copy_to_model`` is the identity forward with the model group's sum in the
backward, ``reduce_from_model`` the sum forward with the identity backward
(``parallel/mesh.py``). The partial sums are reduced in the activations'
dtype, as GSPMD and Megatron-LM reduce them: in bf16 each rank's partial
product is rounded before the sum, so the sharded forward rounds otherwise
than the unsharded one (``chip_smoke.py``'s ``[tp forward]`` holds them
by per-marker Pearson). The LoRA adapters stay whole on every rank (JAX:
replicated); each rank's gradients of A and B are partial sums over the
model group, which the train step sums (``train/steps.py``).

Nothing falls back. A head count or MLP hidden width that the model group
does not divide, an ``Int8Linear`` encoder (its per-row activation scale
would need a max over the group), a sequence-sharded encoder (both use the
model axis, as in JAX) and a model without a ViT encoder raise
``ValueError``; a mesh without a process group raises ``RuntimeError``; all
before any collective.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_bshd, attention_qkv
from ..ops.mlp import swiglu_fc1
from .mesh import Mesh, copy_to_model, reduce_from_model

# a block's parameters by the JAX rule (sharding.py:38-55), names relative to
# the block; with LoRA live the qkv Linear sits at ``attn.qkv.qkv``
COLUMN = ("attn.qkv.weight", "attn.qkv.bias", "attn.qkv.qkv.weight", "attn.qkv.qkv.bias",
          "mlp.fc1.weight", "mlp.fc1.bias")
ROW = ("attn.proj.weight", "mlp.fc2.weight")

# (parts, dim) of a sharded tensor: its ``parts`` equal sections along ``dim``
# (qkv 3, the SwiGLU fc1 2), each cut into n contiguous blocks, rank r's
# blocks packed in section order
Layout = Tuple[int, int]


def shard_slice(t: torch.Tensor, layout: Layout, n: int, r: int) -> torch.Tensor:
    """Rank r's part of the whole tensor ``t`` (a new contiguous tensor)."""
    parts, dim = layout
    return torch.cat([c.chunk(n, dim)[r] for c in t.chunk(parts, dim)], dim)


def unshard(shards: Sequence[torch.Tensor], layout: Layout) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_slice``, in rank order."""
    parts, dim = layout
    pieces = [s.chunk(parts, dim) for s in shards]
    return torch.cat([torch.cat([p[j] for p in pieces], dim) for j in range(parts)], dim)


def _shard_linear(lin: nn.Linear, layout: Layout, n: int, r: int, bias: bool) -> Dict[str, Layout]:
    """Cut ``lin``'s weight (and its bias when ``bias``) in place, keeping
    the Parameter objects (an optimizer or train state that holds them
    stays valid); returns the layouts by parameter name."""
    with torch.no_grad():
        lin.weight.data = shard_slice(lin.weight.data, layout, n, r)
        if bias and lin.bias is not None:
            lin.bias.data = shard_slice(lin.bias.data, layout, n, r)
    lin.out_features, lin.in_features = lin.weight.shape
    names = {"weight": layout}
    if bias and lin.bias is not None:
        names["bias"] = layout
    return names


def row_parallel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, group) -> torch.Tensor:
    """A row-split layer: ``x`` (this rank's input columns) times this rank's
    ``w`` (``[out, in / n]``) in x's dtype, summed over ``group``, plus the
    whole bias ``b`` once."""
    return reduce_from_model(F.linear(x, w.to(x.dtype)), group) + b.to(x.dtype)


class ParallelAttention(nn.Module):
    """``models.vit.Attention`` on rank r of a model group of n: this rank's
    ``num_heads / n`` heads of q, k and v (the packed ``qkv`` Linear cut to
    ``[q_r | k_r | v_r]``), the proj weight's matching input columns, the
    proj bias whole. With LoRA live (``qkv`` a ``LoRAQKV``) A and B stay
    whole and the forward uses B's columns of this rank's heads.
    ``layouts``: the sharded parameters' names under this module."""

    def __init__(self, attn: nn.Module, group, n: int, r: int):
        super().__init__()
        from ..models.vit import LoRAQKV

        d = attn.proj.in_features
        self.num_heads = attn.num_heads // n
        self.group = group
        self.lora = isinstance(attn.qkv, LoRAQKV)
        self.cols = slice(r * d // n, (r + 1) * d // n)   # this rank's heads in q and v
        self.qkv = attn.qkv
        self.proj = attn.proj
        inner = "qkv.qkv." if self.lora else "qkv."
        lin = attn.qkv.qkv if self.lora else attn.qkv
        self.layouts = {inner + k: v for k, v in _shard_linear(lin, (3, 0), n, r, True).items()}
        self.layouts["proj.weight"] = _shard_linear(self.proj, (1, 1), n, r, False)["weight"]

    def _lora(self, lora, x):
        return lora.alpha * ((x @ lora.A.to(x.dtype)) @ lora.B[:, self.cols].to(x.dtype))

    def forward(self, x, shard=None):
        if shard is not None:
            raise ValueError("a tensor-parallel block does not take a token shard: "
                             "attn_impl='seq_shard' and tensor sharding both use the model axis")
        x = copy_to_model(x, self.group)
        if self.lora:
            q, k, v = self.qkv.qkv(x).chunk(3, dim=-1)
            out = attention_bshd(q + self._lora(self.qkv.lora_q, x), k,
                                 v + self._lora(self.qkv.lora_v, x), self.num_heads)
        else:
            out = attention_qkv(self.qkv(x), self.num_heads)
        return row_parallel(out, self.proj.weight, self.proj.bias, self.group)


class ParallelMlp(nn.Module):
    """``models.vit.Mlp`` on rank r of a model group of n: rows
    ``[r H / n, (r + 1) H / n)`` of fc1 (of each SwiGLU half, packed
    ``[a_r | g_r]``: K2 at hidden ``H / n``), fc2's matching input columns,
    the fc2 bias whole. ``layouts`` as ``ParallelAttention``'s."""

    def __init__(self, mlp: nn.Module, group, n: int, r: int):
        super().__init__()
        self.swiglu = mlp.swiglu
        self.group = group
        self.fc1 = mlp.fc1
        self.fc2 = mlp.fc2
        self.layouts = {"fc1." + k: v for k, v in _shard_linear(
            self.fc1, (2 if self.swiglu else 1, 0), n, r, True).items()}
        self.layouts["fc2.weight"] = _shard_linear(self.fc2, (1, 1), n, r, False)["weight"]

    def forward(self, x):
        x = copy_to_model(x, self.group)
        if self.swiglu:
            h = swiglu_fc1(x, self.fc1.weight, self.fc1.bias)
        else:
            h = F.gelu(self.fc1(x))
        return row_parallel(h, self.fc2.weight, self.fc2.bias, self.group)


def _vits(model: nn.Module):
    from ..models.vit import VisionTransformer

    return [(name, m) for name, m in model.named_modules() if isinstance(m, VisionTransformer)]


def encoder_param_specs(model: nn.Module) -> Dict[str, str | None]:
    """Every parameter's class by the JAX ``encoder_param_specs`` rule:
    ``"column"`` (split output: the qkv and fc1 weights and biases of each
    block of a ViT encoder: the flagship's ``encoder.vit``, ``UnetrViT``'s
    ``encoder.model``, a bare ViT), ``"row"`` (split input: the proj and
    fc2 weights) or None (replicated: everything else). The names are the
    same before and after ``shard_params``."""
    specs = {name: None for name, _ in model.named_parameters()}
    for prefix, vit in _vits(model):
        base = f"{prefix}.blocks." if prefix else "blocks."
        for name, _ in vit.blocks.named_parameters():
            rest = name.split(".", 1)[1]
            if rest in COLUMN:
                specs[base + name] = "column"
            elif rest in ROW:
                specs[base + name] = "row"
    return specs


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace every block's ``attn`` and ``mlp`` of ``model``'s ViT
    encoder by its tensor-parallel twin holding this rank's slices over
    ``mesh``'s model group (in place; returns the model). A model group of
    one rank leaves the model as it is. Apply it to the model as it will
    run: after ``merge_lora`` and ``cast_params`` for serving, before
    ``create_train_state`` for training."""
    from ..models.vit import Int8Linear

    vits = _vits(model)
    if not vits:
        raise ValueError("shard_params splits a ViT encoder; this model has none")
    n = mesh.n_model
    for _, vit in vits:
        cfg = vit.cfg
        if any(isinstance(m, (ParallelAttention, ParallelMlp)) for m in vit.modules()):
            raise ValueError("the encoder is sharded already")
        if cfg.attn_impl == "seq_shard":
            raise ValueError("attn_impl='seq_shard' and tensor sharding both use the model axis")
        if any(isinstance(m, Int8Linear) for m in vit.modules()):
            raise ValueError("an Int8Linear encoder is not tensor-parallel: the row-split proj "
                             "and fc2 would need their per-row activation scale reduced over "
                             "the model group")
        if cfg.num_heads % n or cfg.mlp_hidden_dim % n:
            raise ValueError(f"{cfg.num_heads} heads and an MLP hidden width of "
                             f"{cfg.mlp_hidden_dim} do not both split over {n} model ranks")
    if n == 1:
        return model
    if mesh.model_group is None or not dist.is_initialized():
        raise RuntimeError(f"a model group of {n} ranks needs a running process group "
                           "(make_mesh after init_distributed)")
    for _, vit in vits:
        for blk in vit.blocks:
            blk.attn = ParallelAttention(blk.attn, mesh.model_group, n, mesh.model_rank)
            blk.mlp = ParallelMlp(blk.mlp, mesh.model_group, n, mesh.model_rank)
    return model


def _twins(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (ParallelAttention, ParallelMlp))]


def param_layouts(model: nn.Module) -> Dict[str, Layout]:
    """The sharded parameters of a ``shard_params`` model by name, with
    their layouts (empty for a model that is not sharded)."""
    return {f"{prefix}.{name}": layout for prefix, twin in _twins(model)
            for name, layout in twin.layouts.items()}


def partial_params(model: nn.Module) -> List[str]:
    """The replicated parameters inside a column branch of a ``shard_params``
    model: the live LoRA adapters, whose gradients each rank holds a partial
    sum of."""
    return [f"{prefix}.qkv.{lq}.{p}" for prefix, twin in _twins(model)
            if isinstance(twin, ParallelAttention) and twin.lora
            for lq in ("lora_q", "lora_v") for p in ("A", "B")]


def shard_opt_state(opt_state, model: nn.Module, mesh: Mesh):
    """Slice ``opt_state``'s whole moments (``mu``, ``nu`` and the
    accumulator, an ``AdamChain`` state whose lists follow ``model``'s
    trainable tensors in order) of each sharded trainable tensor of the
    ``shard_params`` model as the tensor itself is sliced, as the JAX
    function places the moments with their parameters; e.g. a replicated
    state restored from a snapshot. In place; returns the state. Raises
    ``ValueError`` when the state does not follow the model's trainable
    tensors or a moment is not whole."""
    layouts = param_layouts(model)
    trainable = [(name, p) for name, p in model.named_parameters() if p.requires_grad]
    if len(trainable) != len(opt_state.mu):
        raise ValueError(f"the state holds {len(opt_state.mu)} moments, the model "
                         f"{len(trainable)} trainable tensors")
    n, r = mesh.n_model, mesh.model_rank
    for field in ("mu", "nu", "acc"):
        moments = getattr(opt_state, field)
        if moments is None:
            continue
        out = list(moments)
        for i, (name, p) in enumerate(trainable):
            if name not in layouts:
                continue
            part = shard_slice(out[i], layouts[name], n, r)
            if part.shape != p.shape:
                raise ValueError(f"{field} of {name}: {tuple(out[i].shape)} is not the whole "
                                 f"of a shard {tuple(p.shape)}")
            out[i] = part
        setattr(opt_state, field, out)
    return opt_state
