"""The fused ViT attention sublayer, LayerNorm -> qkv projection -> softmax
attention: the K8 CUDA kernel and its plain twin, with autograd.

``ln_qkv_attention(x, ln_scale, ln_bias, w, b, num_heads)`` is the
counterpart of ``mipheivit_tpu/ops/attn_block.py::ln_qkv_attention``: x
``[B, S, D]``, ``w`` the block's ``attn.qkv`` weight in ``nn.Linear`` layout
``[3*H*Dh, D]`` (q | k | v rows; the JAX package takes ``[D, 3*H*Dh]``),
``b [3*H*Dh]`` -> the attention output ``[B, S, H*Dh]``, before the output
projection. No model calls it; it is the fused alternative to the
sublayer's ``norm1 -> qkv -> attention_qkv``.

On CUDA tensors ``route`` picks the kernels, for what the JAX entry point
answers (through its kernel or its chain): K8 (``csrc/attn_block.cu``) for
1 <= S <= 1024, with head dims below 64 padded to 64 by zero weight rows and
zero bias of each head (exact; the scale stays that of the head's own Dh),
and D not a multiple of 8 zero-padded to one (zero columns of x and w, zero
LayerNorm scale and bias there, the row statistics over the true D: exact);
above 1024 tokens, and at head dims from 65 to 128 at any length, K7 ->
K4, ``ln_matmul`` then ``attention_qkv`` (K4's 128-wide instance for those
heads), the structure of the JAX chain with every launch a kernel. Head
dims above 128 and empty shapes raise on the card before any launch. K8
computes the TPU kernel's function:
the LN rows rounded to x's dtype, ``q|k|v`` with the f32 bias inside the f32
accumulation and one rounding, ``exp2`` of the log2-scaled logits, the exact
row max, the f32 row sum, ``p`` rounded to v's dtype and the division after
``p . v``; the normed activations and the qkv buffer stay out of device
memory. On CPU tensors the same routes run the plain versions:
``chain_reference``, the counterpart of ``_chain_reference``, which rounds
the bias into qkv in x's dtype and normalises p before ``p . v`` (in bf16
the two differ by about one rounding), and on the K7 -> K4 route
``ln_matmul`` and ``attention_qkv`` on the CPU.

Training. K8's backward is the vjp of ``chain_reference`` from the saved
inputs, the counterpart of ``_fused_bwd_rule``; the K7 -> K4 route's is that
of its two entry points.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .. import _build
from .attention import MAX_HEAD_DIM, attention_qkv
from .mlp import kernel_ln_params, ln_matmul, ln_rows, pad_ln_matmul

HEAD_DIM = 64   # K8's head dim; smaller head dims are padded to it
MAX_SEQ = 1024  # K8's longest sequence; longer ones take K7 -> K4

# K8 launches since the last reset, counted where the kernel is launched
launch_counts = {"attn_block": 0}


def chain_reference(x, ln_scale, ln_bias, w, b, num_heads: int, eps: float = 1e-6,
                    scale: float | None = None, width: int | None = None):
    """The plain sublayer (the JAX package's ``_chain_reference``): the LN
    with f32 statistics rounded to x's dtype (``ln_rows``; with ``width``
    the statistics over each row's first ``width`` values, for x padded by
    ``mlp.pad_ln_matmul``), ``qkv = normed @ w^T + b`` in x's dtype, f32 logits
    scaled by ``scale`` (``1/sqrt(Dh)`` unless given: a head padded to 64
    keeps its own Dh's), the f32 softmax cast to v's dtype, ``p . v`` ->
    ``[B, S, H*Dh]`` in x's dtype."""
    normed = ln_rows(x, ln_scale, ln_bias, eps, width)
    qkv = F.linear(normed, w.to(x.dtype)) + b.to(x.dtype)
    bsz, s, _ = x.shape
    hd = w.shape[0] // 3
    dh = hd // num_heads

    def heads(t):
        return t.reshape(bsz, s, num_heads, dh).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(hd, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(dh) if scale is None else logits * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(v.dtype)
    return out.transpose(1, 2).reshape(bsz, s, hd)


def pad_head_rows(w, b, num_heads: int):
    """w ``[3*H*Dh, D]`` and b ``[3*H*Dh]`` -> ``[3*H*64, D]`` and
    ``[3*H*64]``: each head's Dh rows of q, k and v, then zero rows and a
    zero bias (``w`` and ``b`` themselves at Dh = 64). With them the
    sublayer at Dh = 64 and the scale of the original Dh is the original
    one, each head followed by 64 - Dh zero columns."""
    d = w.shape[1]
    dh = w.shape[0] // 3 // num_heads
    if dh == HEAD_DIM:
        return w, b
    return (F.pad(w.reshape(3, num_heads, dh, d), (0, 0, 0, HEAD_DIM - dh)).reshape(-1, d),
            F.pad(b.reshape(3, num_heads, dh), (0, HEAD_DIM - dh)).reshape(-1))


def route(b: int, s: int, d: int, heads: int, head_dim: int) -> str:
    """The kernels ``ln_qkv_attention`` launches on the card for x ``[b, s,
    d]`` and ``heads`` heads of ``head_dim``: ``"k8"`` up to 1024 tokens at
    a head dim up to 64, ``"k7+attention_qkv"`` above 1024 tokens or 64
    (``ln_matmul``, then ``attention_qkv``, which is K4 there), at any D
    (padded to a multiple of 8). Raises ValueError where no kernel takes the
    shape: a head dim above 128, an empty shape. The plain versions on the
    CPU take the same routes, at any head dim."""
    if min(b, s, d, heads) < 1:
        raise ValueError(f"ln_qkv_attention takes a non-empty x [B, S, D] and H >= 1, got "
                         f"B={b}, S={s}, D={d}, H={heads}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"ln_qkv_attention takes a head dim from 1 to {MAX_HEAD_DIM} on the "
                         f"card (zero-padded to 64 or 128), got {head_dim}")
    return _route(s, head_dim)


def _route(s: int, head_dim: int) -> str:
    return "k8" if s <= MAX_SEQ and head_dim <= HEAD_DIM else "k7+attention_qkv"


def ln_qkv_attention(x, ln_scale, ln_bias, w, b, num_heads: int, eps: float = 1e-6):
    """LayerNorm -> qkv projection -> multi-head attention on x ``[B, S,
    D]`` with ``w [3*H*Dh, D]`` and ``b [3*H*Dh]`` -> ``[B, S, H*Dh]``: on
    the card the kernels ``route`` names, on the CPU their plain versions.
    Differentiable in x, the LayerNorm's scale and bias, w and b. w and b
    are cast to x's dtype."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[-1] or w.shape[0] % 3 \
            or (w.shape[0] // 3) % num_heads or b.shape != (w.shape[0],):
        raise ValueError(f"ln_qkv_attention takes x [B, S, D], w [3*H*Dh, D] and b [3*H*Dh] "
                         f"with H = {num_heads}, got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    devices = {t.device.type for t in (x, ln_scale, ln_bias, w, b)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"ln_qkv_attention needs its tensors all on the CPU or all on one "
                         f"CUDA device, got {sorted(devices)}")
    bsz, s, d = x.shape
    head_dim = w.shape[0] // 3 // num_heads
    if devices == {"cuda"}:
        which = route(bsz, s, d, num_heads, head_dim)
    else:  # the plain versions take any D and head dim
        which = _route(s, head_dim)
    w, b = w.to(x.dtype), b.to(x.dtype)
    if which == "k7+attention_qkv":
        return attention_qkv(ln_matmul(x, ln_scale, ln_bias, w, b, eps), num_heads)
    return _LnQkvAttention.apply(x, ln_scale, ln_bias, w, b, num_heads, eps)


class _LnQkvAttention(torch.autograd.Function):
    """K8 (the plain chain on the CPU); the backward is autograd through
    ``chain_reference`` from the saved inputs."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, b, num_heads, eps):
        if x.device.type == "cpu":
            out = chain_reference(x, ln_scale, ln_bias, w, b, num_heads, eps)
        else:
            out = _attn_block_cuda(x, ln_scale, ln_bias, w, b, num_heads, eps)
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(x, ln_scale, ln_bias, w, b)
        return out

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = chain_reference(*ins, ctx.num_heads, ctx.eps)
        grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], dout))
        return (*(next(grads) if t.requires_grad else None for t in ins), None, None)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("attn_block")
    for fn in (lib.k8_attn_block_bf16, lib.k8_attn_block_f32):
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.k8_error_string.argtypes = [ctypes.c_int]
    lib.k8_error_string.restype = ctypes.c_char_p
    return lib


def _attn_block_cuda(x, ln_scale, ln_bias, w, b, num_heads: int, eps: float):
    """Launch K8 on x ``[B, S, D]`` (unit column stride), the LayerNorm's
    scale and bias ``[D]``, w ``[3*H*Dh, D]`` and b ``[3*H*Dh]`` (x's
    dtype). Head dims below 64 are padded to 64 here (``pad_head_rows``), D
    to a multiple of 8 (``mlp.pad_ln_matmul``, the statistics over the true
    D); in bf16, x and w without 16-byte aligned rows are copied. Returns
    ``[B, S, H*Dh]`` in x's dtype."""
    if x.dim() != 3:
        raise ValueError(f"K8 takes x [B, S, D], got {tuple(x.shape)}")
    bsz, s, d = x.shape
    hd3 = w.shape[0]
    ts = (x, ln_scale, ln_bias, w, b)
    if len({t.device for t in ts}) != 1:
        raise ValueError("K8's operands lie on different devices")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError(f"K8 takes bf16 or f32 x, w and b of one dtype, got "
                         f"{x.dtype}, {w.dtype}, {b.dtype}")
    dh = hd3 // 3 // num_heads
    if w.shape != (hd3, d) or b.shape != (hd3,) or ln_scale.shape != (d,) \
            or ln_bias.shape != (d,) or hd3 != 3 * num_heads * dh or not 1 <= dh <= HEAD_DIM:
        raise ValueError(f"K8 takes a head dim from 1 to {HEAD_DIM}: x [B, S, D], scale and bias "
                         f"[D], w [3*H*Dh, D], b [3*H*Dh] with H = {num_heads}, got "
                         f"{tuple(x.shape)}, {tuple(ln_scale.shape)}, {tuple(ln_bias.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if not 1 <= s <= MAX_SEQ or bsz < 1 or d < 1:
        raise ValueError(f"K8 takes 1 <= S <= {MAX_SEQ} and D >= 1, got S={s}, D={d}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("K8 is launched raw with grad enabled; go through ln_qkv_attention, "
                         "whose autograd Function runs the backward")
    if x.stride(2) != 1:
        raise ValueError(f"K8 needs x with a unit column stride, got strides {x.stride()}")
    w, b = pad_head_rows(w, b, num_heads)
    x, ln_scale, ln_bias, w, b = pad_ln_matmul(x, ln_scale, ln_bias, w, b)
    w, b = w.contiguous(), b.contiguous()
    if x.dtype == torch.bfloat16:  # TMA reads 16-byte aligned rows
        if x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8:
            x = x.contiguous()
        if w.data_ptr() % 16:
            w = w.clone()
    dp = x.shape[-1]
    ln_w, ln_b = kernel_ln_params(ln_scale, ln_bias)
    stats = torch.empty((2, bsz * s), dtype=torch.float32, device=x.device)

    lib = _library()
    fn = lib.k8_attn_block_bf16 if x.dtype == torch.bfloat16 else lib.k8_attn_block_f32
    out = torch.empty((bsz, s, num_heads * HEAD_DIM), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), x.stride(0), x.stride(1), ln_w.data_ptr(), ln_b.data_ptr(),
                 w.data_ptr(), b.data_ptr(), stats.data_ptr(), out.data_ptr(), bsz, s, dp,
                 num_heads, d, eps, math.log2(math.e) / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"K8 attention block launch failed: "
                           f"{lib.k8_error_string(err).decode()} ({err})")
    launch_counts["attn_block"] += 1
    if dh == HEAD_DIM:
        return out
    return out.view(bsz, s, num_heads, HEAD_DIM)[..., :dh].reshape(bsz, s, num_heads * dh)
