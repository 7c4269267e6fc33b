"""Tensor parallelism for the ViT and Swin encoders (PyTorch).

The port's counterpart of ``mipheivit_tpu/parallel/sharding.py``. The JAX
package annotates the parameters with Megatron column and row splits over
the mesh's ``model`` axis and lets GSPMD insert the collectives; the port
holds each rank's slices in tensor-parallel twins of the blocks' ``attn``
and ``mlp`` and calls the collectives itself:

- ``encoder_param_specs(model)``: each parameter's class by the JAX rule
  (``"column"``: the qkv and fc1 weights and biases; ``"row"``: the proj
  and fc2 weights; None: the rest, the LoRA adapters, the norms, the layer
  scales, the relative-position tables, the proj and fc2 biases and the
  decoder among them), and an ``Int8Linear``'s buffers (its ``scale``
  follows a column weight and stays whole beside a row one);
- ``shard_params(model, mesh)``: every ViT block's ``attn`` and ``mlp``
  replaced by a ``ParallelAttention`` and a ``ParallelMlp``, every Swin
  block's ``attn`` by a ``ParallelWindowAttention``, each holding this
  rank's slices;
- ``shard_opt_state(opt_state, model, mesh)``: the optimizer moments of the
  trainable sharded tensors sliced the same way.

The JAX rule matches ``attn/qkv``, ``attn/proj``, ``mlp/fc1`` and
``mlp/fc2`` on any module path. The Swin block's MLP is ``mlp_fc1`` /
``mlp_fc2`` there, which the rule never matches, so it stays whole on every
rank; the port names it ``mlp.fc1`` / ``mlp.fc2``, and its classes are
decided by block type, not by name.

The layout is head-aligned where the JAX one is not. JAX splits the output
axis of the packed qkv kernel ``[q | k | v]`` into contiguous blocks (at 2
ranks, rank 0 holds all of q and half of k) and GSPMD reshards for the
attention. The port keeps attention local: rank r takes its heads' rows of
each section, packed ``[q_r | k_r | v_r]``, so that K1 (or K4 above 512
tokens) reads that buffer in place at ``num_heads / n`` heads. The packed
SwiGLU fc1 ``[a | g]`` is cut the same way, ``[a_r | g_r]``, so that K2
runs at hidden ``H / n``. Where the model group does not divide a Swin
stage's heads (ctranspath's 3 at 2 ranks), the first ``heads % n`` ranks
take one head more and a rank may take none (``split_heads``). The
function computed is the JAX one; only which rank holds which columns
differs.

A block on rank r of a model group of n:

  attn: copy_to_model(x) -> qkv_r (LoRA live: + alpha x A B[:, heads_r])
        -> attention at this rank's heads (Swin: the bias table's columns
        of them) -> proj_r (its input columns) -> reduce_from_model
        -> + proj bias
  mlp:  copy_to_model(x) -> fc1_r (K2 at H / n, or GELU) -> fc2_r
        -> reduce_from_model -> + fc2 bias          (ViT; Swin: whole)

``copy_to_model`` is the identity forward with the model group's sum in the
backward, ``reduce_from_model`` the sum forward with the identity backward
(``parallel/mesh.py``). The partial sums are reduced in the activations'
dtype, as GSPMD and Megatron-LM reduce them: in bf16 each rank's partial
product is rounded before the sum, so the sharded forward rounds otherwise
than the unsharded one (``chip_smoke.py``'s ``[tp forward]`` holds them
by per-marker Pearson). The LoRA adapters and the Swin bias tables stay
whole on every rank (JAX: replicated); each rank's gradients of them are
partial sums over the model group, which the train step sums
(``train/steps.py``).

An ``Int8Linear`` encoder (``infer.loading.quantize_encoder`` before
``shard_params``) shards the same way. A column layer cuts its int8
weight, per-output ``scale`` and bias together; its input is whole, so each
row's activation scale is already the whole row's. A row layer takes the
max of its input slice's per-row ``amax`` over the model group
(``max_over_model``), quantises with that scale, and sums its int32 partial
accumulators over the group (``sum_int_over_model``): integer addition is
exact, so the accumulator equals the unsharded one bit for bit; then it
dequantises with the whole ``scale`` and adds the bias once.

Nothing falls back. A ViT head count or MLP hidden width that the model
group does not divide, a Swin stage width it does not divide (JAX's
contiguous split of qkv and proj needs it too), a sequence-sharded encoder
(both use the model axis, as in JAX) and a model without a ViT or Swin
encoder raise ``ValueError``; a mesh without a process group raises
``RuntimeError``; all before any collective.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.swin import SwinBlock, SwinTransformer, WindowAttention
from ..models.vit import Block, Int8Linear, LoRAQKV, Mlp, VisionTransformer
from ..ops import quant
from ..ops.attention import attention_bshd, attention_qkv
from .mesh import Mesh, copy_to_model, max_over_model, reduce_from_model, sum_int_over_model

# a block's tensors by the JAX rule (sharding.py:38-55), names relative to
# the block; with LoRA live the qkv Linear sits at ``attn.qkv.qkv``; an
# Int8Linear's ``scale`` follows a column weight (JAX replicates it and
# GSPMD slices it at use)
COLUMN = ("attn.qkv.weight", "attn.qkv.bias", "attn.qkv.scale", "attn.qkv.qkv.weight",
          "attn.qkv.qkv.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc1.scale")
ROW = ("attn.proj.weight", "mlp.fc2.weight")
# a Swin block's: its attention alone (JAX's mlp_fc1 / mlp_fc2 match no rule)
SWIN_COLUMN = tuple(c for c in COLUMN if c.startswith("attn."))
SWIN_ROW = ("attn.proj.weight",)


class Layout(NamedTuple):
    """How a tensor is cut: ``parts`` equal sections along ``dim`` (qkv 3,
    the SwiGLU fc1 2, else 1), rank r taking ``sizes[r]`` contiguous
    entries of each section, its pieces packed in section order."""

    parts: int
    dim: int
    sizes: Tuple[int, ...]


def split_heads(heads: int, n: int) -> Tuple[int, ...]:
    """Whole heads a rank over ``n`` ranks: the first ``heads % n`` take one
    more; a rank may take none."""
    return tuple(heads // n + (r < heads % n) for r in range(n))


def shard_slice(t: torch.Tensor, layout: Layout, r: int) -> torch.Tensor:
    """Rank r's part of the whole tensor ``t`` (a new contiguous tensor)."""
    parts, dim, sizes = layout
    start = sum(sizes[:r])
    return torch.cat([c.narrow(dim, start, sizes[r]) for c in t.chunk(parts, dim)], dim)


def unshard(shards: Sequence[torch.Tensor], layout: Layout) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_slice``, in rank order."""
    parts, dim, sizes = layout
    pieces = [s.split([size] * parts, dim) for s, size in zip(shards, sizes)]
    return torch.cat([p[j] for j in range(parts) for p in pieces], dim)


def gather_whole(t: torch.Tensor, layout: Layout, group) -> torch.Tensor:
    """The whole tensor from this rank's shard ``t``, gathered over
    ``group`` (every rank of it calls); shards of uneven sizes travel
    zero-padded to the largest."""
    parts, dim, sizes = layout
    padded = F.pad(t.detach(), [0, 0] * (t.ndim - 1 - dim) + [0, parts * max(sizes) - t.shape[dim]])
    bufs = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(bufs, padded.contiguous(), group=group)
    return unshard([b.narrow(dim, 0, parts * s) for b, s in zip(bufs, sizes)], layout)


def _shard_linear(lin: nn.Module, layout: Layout, r: int, column: bool) -> Dict[str, Layout]:
    """Cut ``lin``'s weight in place (and a column layer's bias and int8
    ``scale``), keeping the Parameter objects (an optimizer or train state
    that holds them stays valid); an ``Int8Linear``'s buffers are
    replaced. Returns the layouts by tensor name."""
    cut = {}
    with torch.no_grad():
        for name in ("weight", "bias", "scale") if column else ("weight",):
            t = getattr(lin, name, None)
            if t is None:
                continue
            part = shard_slice(t.detach(), layout, r)
            if isinstance(t, nn.Parameter):
                t.data = part
            else:
                setattr(lin, name, part)
            cut[name] = layout
    lin.out_features, lin.in_features = lin.weight.shape
    return cut


def int8_row_accumulator(x2: torch.Tensor, w_i8: torch.Tensor, group
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An int8 row-split layer's product before dequantisation: ``x2 [M,
    K_r]`` (this rank's input columns) quantised per row at the whole row's
    scale (the max of the ranks' ``amax`` over ``group``), times this
    rank's codes ``w_i8 [N, K_r]``, the int32 partial sums summed over the
    group. Returns ``(acc [M, N] int32, sx [M, 1] f32)``, equal to the
    unsharded layer's bit for bit. On the card the product is
    ``ops.quant.int_mm``; on the CPU ``int8_matmul_reference``'s."""
    amax = max_over_model(quant.row_amax(x2), group)
    x_i8, sx = quant.quantize_rows(x2, amax)
    if x2.device.type == "cuda":
        acc = quant.int_mm(x_i8, w_i8)
    elif x2.device.type == "cpu":
        acc = torch._int_mm(x_i8, w_i8.t().contiguous())
    else:
        raise ValueError(f"an int8 row-split layer runs on the card or the CPU, not {x2.device}")
    return sum_int_over_model(acc.contiguous(), group), sx


def row_parallel(x: torch.Tensor, lin: nn.Module, group) -> torch.Tensor:
    """A row-split layer: ``x`` (this rank's input columns) times this
    rank's weight of ``lin`` (``[out, in / n]``), summed over ``group``,
    plus the whole bias once. A float layer multiplies in x's dtype and
    sums in it; an ``Int8Linear`` sums its int32 accumulators
    (``int8_row_accumulator``) and dequantises after the sum."""
    if isinstance(lin, Int8Linear):
        lead = x.shape[:-1]
        acc, sx = int8_row_accumulator(x.reshape(-1, x.shape[-1]), lin.weight, group)
        return quant.dequantize(acc, sx, lin.scale, lin.bias, x.dtype).reshape(*lead, -1)
    return reduce_from_model(F.linear(x, lin.weight.to(x.dtype)), group) + lin.bias.to(x.dtype)


def _shard_heads(twin: nn.Module, attn: nn.Module, heads: int, head_dim: int, group, n: int,
                 r: int) -> None:
    """Set up ``twin`` as rank r's part of the attention ``attn`` of
    ``heads`` heads: this rank's heads of the packed qkv (``[q_r | k_r |
    v_r]``), the proj weight's matching input columns; ``twin.layouts``
    the cut tensors' layouts by name."""
    sizes = split_heads(heads, n)
    start = sum(sizes[:r])
    twin.group, twin.num_heads, twin.head_dim = group, sizes[r], head_dim
    twin.heads = slice(start, start + sizes[r])
    twin.cols = slice(start * head_dim, (start + sizes[r]) * head_dim)   # in q and v
    twin.lora = isinstance(attn.qkv, LoRAQKV)
    twin.qkv, twin.proj = attn.qkv, attn.proj
    widths = tuple(s * head_dim for s in sizes)
    inner, lin = ("qkv.qkv.", attn.qkv.qkv) if twin.lora else ("qkv.", attn.qkv)
    twin.layouts = {inner + k: v for k, v in _shard_linear(lin, Layout(3, 0, widths), r,
                                                          True).items()}
    twin.layouts.update({"proj." + k: v for k, v in _shard_linear(attn.proj, Layout(1, 1, widths),
                                                                  r, False).items()})


def _lora(lora, x, cols):
    return lora.alpha * ((x @ lora.A.to(x.dtype)) @ lora.B[:, cols].to(x.dtype))


def _heads_qkv(twin: nn.Module, x: torch.Tensor):
    """This rank's q, k, v of ``x``: its heads' sections, with LoRA live
    the adapters' terms through B's columns of its heads."""
    if not twin.lora:
        return twin.qkv(x).tensor_split(3, dim=-1)
    q, k, v = twin.qkv.qkv(x).tensor_split(3, dim=-1)
    return (q + _lora(twin.qkv.lora_q, x, twin.cols), k,
            v + _lora(twin.qkv.lora_v, x, twin.cols))


class ParallelAttention(nn.Module):
    """``models.vit.Attention`` on rank r of a model group of n: this rank's
    ``num_heads / n`` heads of q, k and v (the packed ``qkv`` Linear or
    ``Int8Linear`` cut to ``[q_r | k_r | v_r]``), the proj weight's matching
    input columns, the proj bias whole. With LoRA live (``qkv`` a
    ``LoRAQKV``) A and B stay whole and the forward uses B's columns of
    this rank's heads. ``layouts``: the sharded tensors' names under this
    module."""

    def __init__(self, attn: nn.Module, group, n: int, r: int):
        super().__init__()
        _shard_heads(self, attn, attn.num_heads, attn.proj.in_features // attn.num_heads, group,
                     n, r)

    def forward(self, x, shard=None):
        if shard is not None:
            raise ValueError("a tensor-parallel block does not take a token shard: "
                             "attn_impl='seq_shard' and tensor sharding both use the model axis")
        x = copy_to_model(x, self.group)
        if self.lora:
            out = attention_bshd(*_heads_qkv(self, x), self.num_heads)
        else:
            out = attention_qkv(self.qkv(x), self.num_heads)
        return row_parallel(out, self.proj, self.group)


class ParallelMlp(Mlp):
    """``models.vit.Mlp`` on rank r of a model group of n: rows
    ``[r H / n, (r + 1) H / n)`` of fc1 (of each SwiGLU half, packed
    ``[a_r | g_r]``: K2 at hidden ``H / n``), fc2's matching input columns,
    the fc2 bias whole. ``layouts`` as ``ParallelAttention``'s."""

    def __init__(self, mlp: nn.Module, group, n: int, r: int):
        nn.Module.__init__(self)
        self.swiglu, self.group, self.fc1, self.fc2 = mlp.swiglu, group, mlp.fc1, mlp.fc2
        widths = (mlp.fc2.in_features // n,) * n
        self.layouts = {"fc1." + k: v for k, v in _shard_linear(
            self.fc1, Layout(2 if self.swiglu else 1, 0, widths), r, True).items()}
        self.layouts.update({"fc2." + k: v for k, v in _shard_linear(
            self.fc2, Layout(1, 1, widths), r, False).items()})

    def forward(self, x):
        return row_parallel(self.hidden(copy_to_model(x, self.group)), self.fc2, self.group)


class ParallelWindowAttention(WindowAttention):
    """``models.swin.WindowAttention`` on rank r of a model group of n: this
    rank's heads (``split_heads``: possibly none) of q, k and v, the
    relative-position table whole and indexed at those heads in the
    forward, the proj weight's matching input columns, the proj bias
    whole; LoRA as ``ParallelAttention``'s. The shift mask is unchanged.
    ``layouts`` as ``ParallelAttention``'s."""

    def __init__(self, attn: WindowAttention, group, n: int, r: int):
        nn.Module.__init__(self)
        self.window = attn.window
        self.relative_position_bias_table = attn.relative_position_bias_table
        _shard_heads(self, attn, attn.num_heads, attn.head_dim, group, n, r)

    def forward(self, x, mask=None):
        x = copy_to_model(x, self.group)
        out = self.attend(*_heads_qkv(self, x), self.relative_position_bias_table[:, self.heads],
                          mask)
        return row_parallel(out, self.proj, self.group)


_TWINS = (ParallelAttention, ParallelMlp, ParallelWindowAttention)


def _encoders(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (VisionTransformer, SwinTransformer))]


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _tensor_names(module: nn.Module) -> List[str]:
    """The parameters' names, and the buffers of every ``Int8Linear`` (its
    int8 weight, scale and bias: the JAX ``Int8Dense``'s params)."""
    names = [name for name, _ in module.named_parameters()]
    names += [_join(prefix, b) for prefix, m in module.named_modules()
              if isinstance(m, Int8Linear) for b, _ in m.named_buffers(recurse=False)]
    return names


def encoder_param_specs(model: nn.Module) -> Dict[str, str | None]:
    """Every parameter's (and ``Int8Linear`` buffer's) class by the JAX
    ``encoder_param_specs`` rule: ``"column"`` (split output: the qkv and
    fc1 weights and biases of each block of a ViT encoder, the flagship's
    ``encoder.vit``, ``UnetrViT``'s ``encoder.model``, a bare ViT; the qkv
    weight and bias of each Swin block), ``"row"`` (split input: the proj
    and fc2 weights; a Swin block's proj weight) or None (replicated:
    everything else, a Swin block's MLP among it). An int8 ``scale`` is
    ``"column"`` beside a column weight. The names are the same before and
    after ``shard_params``."""
    specs = {name: None for name in _tensor_names(model)}
    for prefix, enc in _encoders(model):
        for name, blk in enc.named_modules():
            if not isinstance(blk, (Block, SwinBlock)):
                continue
            column, row = (COLUMN, ROW) if isinstance(blk, Block) else (SWIN_COLUMN, SWIN_ROW)
            base = _join(prefix, name) + "."
            for rest in _tensor_names(blk):
                if rest in column:
                    specs[base + rest] = "column"
                elif rest in row:
                    specs[base + rest] = "row"
    return specs


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace every ViT block's ``attn`` and ``mlp`` and every Swin block's
    ``attn`` of ``model``'s encoders by their tensor-parallel twins holding
    this rank's slices over ``mesh``'s model group (in place; returns the
    model). A model group of one rank leaves the model as it is. Apply it
    to the model as it will run: after ``merge_lora``, ``cast_params`` and
    (int8) ``quantize_encoder`` for serving, before ``create_train_state``
    for training."""
    encoders = _encoders(model)
    if not encoders:
        raise ValueError("shard_params splits ViT and Swin encoders; this model has none")
    n = mesh.n_model
    for _, enc in encoders:
        cfg = enc.cfg
        if any(isinstance(m, _TWINS) for m in enc.modules()):
            raise ValueError("the encoder is sharded already")
        if isinstance(enc, SwinTransformer):
            widths = [cfg.stage_dim(i) for i in range(cfg.num_stages)]
            if any(w % n for w in widths):
                raise ValueError(f"Swin stage widths {widths} do not all split over {n} model "
                                 "ranks (nor do JAX's contiguous qkv and proj splits)")
            continue
        if cfg.attn_impl == "seq_shard":
            raise ValueError("attn_impl='seq_shard' and tensor sharding both use the model axis")
        if cfg.num_heads % n or cfg.mlp_hidden_dim % n:
            raise ValueError(f"{cfg.num_heads} heads and an MLP hidden width of "
                             f"{cfg.mlp_hidden_dim} do not both split over {n} model ranks")
    if n == 1:
        return model
    if mesh.model_group is None or not dist.is_initialized():
        raise RuntimeError(f"a model group of {n} ranks needs a running process group "
                           "(make_mesh after init_distributed)")
    group, r = mesh.model_group, mesh.model_rank
    for _, enc in encoders:
        if isinstance(enc, SwinTransformer):
            for stage in enc.layers:
                for blk in stage.blocks:
                    blk.attn = ParallelWindowAttention(blk.attn, group, n, r)
            continue
        for blk in enc.blocks:
            blk.attn = ParallelAttention(blk.attn, group, n, r)
            blk.mlp = ParallelMlp(blk.mlp, group, n, r)
    return model


def _twins(model: nn.Module):
    return [(name, m) for name, m in model.named_modules() if isinstance(m, _TWINS)]


def param_layouts(model: nn.Module) -> Dict[str, Layout]:
    """The sharded tensors of a ``shard_params`` model by name, with their
    layouts (empty for a model that is not sharded)."""
    return {f"{prefix}.{name}": layout for prefix, twin in _twins(model)
            for name, layout in twin.layouts.items()}


def partial_params(model: nn.Module) -> List[str]:
    """The replicated parameters inside a column branch of a ``shard_params``
    model, whose gradients each rank holds a partial sum of: the live LoRA
    adapters and the Swin blocks' relative-position tables (nonzero only
    in this rank's heads' columns)."""
    names = []
    for prefix, twin in _twins(model):
        if isinstance(twin, ParallelMlp):
            continue
        if twin.lora:
            names += [f"{prefix}.qkv.{lq}.{p}" for lq in ("lora_q", "lora_v") for p in ("A", "B")]
        if isinstance(twin, ParallelWindowAttention):
            names.append(f"{prefix}.relative_position_bias_table")
    return names


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
    for field in ("mu", "nu", "acc"):
        moments = getattr(opt_state, field)
        if moments is None:
            continue
        out = list(moments)
        for i, (name, p) in enumerate(trainable):
            if name not in layouts:
                continue
            layout = layouts[name]
            # a shard passed as whole could slice to the shard's own shape
            whole = out[i].shape[layout.dim] == layout.parts * sum(layout.sizes)
            part = shard_slice(out[i], layout, mesh.model_rank) if whole else None
            if part is None or part.shape != p.shape:
                raise ValueError(f"{field} of {name}: {tuple(out[i].shape)} is not the whole "
                                 f"of a shard {tuple(p.shape)}")
            out[i] = part
        setattr(opt_state, field, out)
    return opt_state
