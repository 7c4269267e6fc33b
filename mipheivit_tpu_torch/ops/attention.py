"""Multi-head attention for the ViT encoder: the K1 CUDA kernel and its plain twin.

q/k/v stay in the ``[B, S, H*D]`` layout that the fused qkv projection
produces, and the output is ``[B, S, H*D]`` for the following projection,
so no head transpose exists on the path (counterpart of
``mipheivit_tpu/ops/attention.py::attention_qkv`` / ``attention_bshd``).

Dispatch is by device only: a CPU tensor runs ``attention_reference``; a
CUDA tensor launches K1 (``csrc/attention.cu``) or raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

MAX_SEQ = 512   # K1's whole-sequence limit, as the TPU kernel's (_MAX_BLOCK)
HEAD_DIM = 64

# Kernel launches since the last reset, counted where the kernel is launched.
launch_counts = {"attention": 0}

_SCALE_LOG2 = math.log2(math.e) / math.sqrt(HEAD_DIM)


def attention_reference(q, k, v, num_heads: int):
    """Plain softmax attention on ``[B, S, H*D]`` tensors (the JAX package's
    ``_attn_reference``): f32 logits, f32 softmax, probs cast to v's dtype,
    f32 accumulation of p . v, output in v's dtype."""
    b, s, hd = q.shape
    d = hd // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, d).float()

    logits = torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k)) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, heads(v))
    return out.reshape(b, s, hd).to(v.dtype)


def attention_qkv(qkv, num_heads: int):
    """Attention off the fused qkv projection ``[B, S, 3*H*D]`` (q | k | v
    sections). On the card the kernel reads the three sections in place."""
    hd = qkv.shape[-1] // 3
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    return attention_bshd(q, k, v, num_heads)


def attention_bshd(q, k, v, num_heads: int):
    """Attention over q/k/v ``[B, S, H*D]`` (any row stride) -> ``[B, S, H*D]``."""
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return attention_reference(q, k, v, num_heads)
    if devices == {"cuda"}:
        return _attention_cuda(q, k, v, num_heads)
    raise ValueError(f"attention needs q, k, v all on the CPU or all on one "
                     f"CUDA device, got {sorted(devices)}")


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("attention")
    for fn in (lib.k1_attention_bf16, lib.k1_attention_f32):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.k1_error_string.argtypes = [ctypes.c_int]
    lib.k1_error_string.restype = ctypes.c_char_p
    return lib


def _attention_cuda(q, k, v, num_heads: int):
    b, s, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v lie on different devices")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K1 takes bf16 or f32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd % num_heads or hd // num_heads != HEAD_DIM:
        raise ValueError(f"K1 takes head dim {HEAD_DIM}, got {hd}/{num_heads}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"K1 takes 1 <= S <= {MAX_SEQ}, got S={s}; "
                         "long-sequence attention is K4, not yet ported")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("K1 needs a unit stride on the last dimension")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("K1 is forward only; its backward comes with training "
                         "(run under torch.inference_mode() or no_grad())")
    if q.dtype == torch.bfloat16:
        # 16-byte vector loads: aligned rows and base pointers
        for t in (q, k, v):
            if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
                raise ValueError("K1 bf16 needs 16-byte aligned rows "
                                 "(strides multiple of 8, aligned base)")

    lib = _library()
    fn = lib.k1_attention_bf16 if q.dtype == torch.bfloat16 else lib.k1_attention_f32
    out = torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), b, s, num_heads, _SCALE_LOG2, stream)
    if err != 0:
        raise RuntimeError(f"K1 attention launch failed: "
                           f"{lib.k1_error_string(err).decode()} ({err})")
    launch_counts["attention"] += 1
    return out
