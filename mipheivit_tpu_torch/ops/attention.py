"""Multi-head attention for the ViT encoder: the K1 and K4 CUDA kernels and
their plain twins.

q/k/v stay in the ``[B, S, H*D]`` layout that the fused qkv projection
produces, and the output is ``[B, S, H*D]`` for the following projection,
so no head transpose exists on the path (counterpart of
``mipheivit_tpu/ops/attention.py::attention_qkv`` / ``attention_bshd`` /
``dot_product_attention`` / ``flash_cross_attention``).

Dispatch is by device and length. A CPU tensor runs the plain versions:
``attention_reference`` for S <= 512, ``flash_reference`` above. A CUDA
tensor launches K1 (``csrc/attention.cu``) for S <= 512 and K4
(``csrc/flash_attention.cu``) above, or raises. There is no fallback from a
kernel to a plain version. (The JAX package sends 512 < S <= 2048 to XLA on
the TPU after a TPU measurement; on the card the kernels serve every
length.)
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

MAX_SEQ = 512   # K1's whole-sequence limit, as the TPU kernel's (_MAX_BLOCK)
HEAD_DIM = 64

# Kernel launches since the last reset, counted where each kernel is launched:
# "attention" is K1, "flash" is K4.
launch_counts = {"attention": 0, "flash": 0}

# The plain flash version holds [B, heads, Sq, Sk] f32 logits: it runs a few
# heads at a time so that one chunk stays near this many elements (1 GiB).
_PLAIN_CHUNK_ELEMENTS = 1 << 28

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


def flash_reference(q, k, v, num_heads: int, seq_len_k: int | None = None):
    """Plain version of K4 (the JAX package's ``_flash_kernel``) on q
    ``[B, Sq, H*D]`` over k/v ``[B, Sk, H*D]``: q/k/v taken as f32, f32
    logits, keys at or past ``seq_len_k`` masked, f32 softmax and f32
    ``p . v``. Returns ``out [B, Sq, H*D]`` in q's dtype and the row
    log-sum-exp ``lse [B, H, Sq]`` f32 (natural log)."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    seq_len_k = sk if seq_len_k is None else seq_len_k

    def heads(t, h0, h1):
        return t[..., h0 * d:h1 * d].reshape(b, t.shape[1], h1 - h0, d).float()

    step = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, b * sq * sk))
    outs, lses = [], []
    for h0 in range(0, num_heads, step):
        h1 = min(num_heads, h0 + step)
        logits = torch.einsum("bqhd,bkhd->bhqk", heads(q, h0, h1),
                              heads(k, h0, h1)) / math.sqrt(d)
        if seq_len_k < sk:
            logits[..., seq_len_k:] = -math.inf
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.exp(logits - lse[..., None])
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, heads(v, h0, h1)))
        lses.append(lse)
        del logits, probs
    out = torch.cat(outs, dim=2).reshape(b, sq, hd).to(q.dtype)
    return out, torch.cat(lses, dim=1)


def flash_attention(q, k, v, num_heads: int, seq_len_k: int | None = None):
    """K4: q ``[B, Sq, H*D]`` over k/v ``[B, Sk, H*D]`` (any row stride), keys
    at or past ``seq_len_k`` masked -> ``(out [B, Sq, H*D], lse [B, H, Sq])``.
    The counterpart of ``flash_cross_attention`` / ``_long_forward``."""
    if _device_type(q, k, v) == "cpu":
        return flash_reference(q, k, v, num_heads, seq_len_k)
    return _flash_cuda(q, k, v, num_heads, seq_len_k)


def attention_qkv(qkv, num_heads: int):
    """Attention off the fused qkv projection ``[B, S, 3*H*D]`` (q | k | v
    sections). On the card the kernels read the three sections in place."""
    hd = qkv.shape[-1] // 3
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    return attention_bshd(q, k, v, num_heads)


def attention_bshd(q, k, v, num_heads: int):
    """Attention over q/k/v ``[B, S, H*D]`` (any row stride) -> ``[B, S, H*D]``:
    K1 (or its plain version) up to 512 tokens, K4 (or its plain version)
    above."""
    if q.shape[1] > MAX_SEQ:
        return flash_attention(q, k, v, num_heads)[0]
    if _device_type(q, k, v) == "cpu":
        return attention_reference(q, k, v, num_heads)
    return _attention_cuda(q, k, v, num_heads)


def _device_type(*tensors) -> str:
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"cuda"}):
        return devices.pop()
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


@functools.lru_cache(maxsize=None)
def _flash_library():
    lib = _build.load("flash_attention")
    for fn in (lib.k4_flash_bf16, lib.k4_flash_f32):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.k4_error_string.argtypes = [ctypes.c_int]
    lib.k4_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name: str, q, k, v, num_heads: int) -> None:
    """What K1 and K4 both need of q/k/v ``[B, S, H*D]``."""
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v lie on different devices")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bf16 or f32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    hd = q.shape[-1]
    if hd % num_heads or hd // num_heads != HEAD_DIM:
        raise ValueError(f"{name} takes head dim {HEAD_DIM}, got {hd}/{num_heads}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} needs a unit stride on the last dimension")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError(f"{name} is forward only; its backward comes with training "
                         "(run under torch.inference_mode() or no_grad())")
    if q.dtype == torch.bfloat16:
        # 16-byte vector loads: aligned rows and base pointers
        for t in (q, k, v):
            if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
                raise ValueError(f"{name} bf16 needs 16-byte aligned rows "
                                 "(strides multiple of 8, aligned base)")


def _attention_cuda(q, k, v, num_heads: int):
    b, s, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"K1 takes 1 <= S <= {MAX_SEQ}, got S={s}")
    _check_operands("K1", q, k, v, num_heads)

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


def _flash_cuda(q, k, v, num_heads: int, seq_len_k: int | None):
    b, sq, hd = q.shape
    sk = k.shape[1]
    if k.dim() != 3 or k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"K4 takes q [B, Sq, H*D] and k, v [B, Sk, H*D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    seq_len_k = sk if seq_len_k is None else seq_len_k
    if sq < 1 or not 1 <= seq_len_k <= sk:
        raise ValueError(f"K4 takes Sq >= 1 and 1 <= seq_len_k <= Sk, got "
                         f"Sq={sq}, seq_len_k={seq_len_k}, Sk={sk}")
    _check_operands("K4", q, k, v, num_heads)

    lib = _flash_library()
    fn = lib.k4_flash_bf16 if q.dtype == torch.bfloat16 else lib.k4_flash_f32
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), b, sq, sk, seq_len_k, num_heads,
                 _SCALE_LOG2, stream)
    if err != 0:
        raise RuntimeError(f"K4 flash attention launch failed: "
                           f"{lib.k4_error_string(err).decode()} ({err})")
    launch_counts["flash"] += 1
    return out, lse
