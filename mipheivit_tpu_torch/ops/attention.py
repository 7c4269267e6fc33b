"""Multi-head attention for the ViT encoder: the K1, K4, K5 and K6 CUDA
kernels and their plain twins, with autograd.

The counterparts of the JAX package's ``mipheivit_tpu/ops/attention.py``:

- ``attention_qkv`` and ``attention_bshd`` are ``attention_qkv`` and
  ``attention_bshd``: q/k/v in the ``[B, S, H*D]`` layout that the fused qkv
  projection produces, the output ``[B, S, H*D]`` for the following
  projection, so no head transpose exists on the path;
- ``dot_product_attention`` is ``dot_product_attention`` over ``[B, H, S,
  D]`` (any strides);
- ``flash_attention`` (with ``seq_len_k`` and a rectangular q) is
  ``flash_cross_attention``, here in the ``[B, S, H*D]`` layout.

The plain versions' f32 arithmetic is f64 for f64 operands (the f64
checks of the training step).

Dispatch is by device and length. A CPU tensor runs the plain versions:
``attention_reference`` for S <= 512, ``flash_reference`` above, and
``short_attention_reference`` for ``dot_product_attention`` up to 512. A
CUDA tensor launches K1 (``csrc/attention.cu``) for S <= 512 and K4
(``csrc/flash_attention.cu``) above; ``dot_product_attention`` launches K6
(``csrc/attention.cu``'s second entry point) up to 512 and K4 above; or
raises. There is no fallback from a kernel to a plain version. (The JAX
package sends 512 < S <= 2048 to XLA on the TPU after a TPU measurement; on
the card the kernels serve every length.)

K1 and K6 compute the softmax in two different orders, as the TPU kernels
do: K1 rounds ``exp(s - max)`` to v's dtype and divides the output by the
row sum, K6 divides the probabilities by the row sum in f32 and then rounds
them.

Training. All run inside a ``torch.autograd.Function``, as the JAX
package's ``custom_vjp`` rules do. K1's and K6's backward is the plain f32
recompute of ``_bshd_bwd_rule`` / ``_flash_bwd_rule`` (the JAX package has
no kernel there either). K4 saves ``(q, k, v, out, lse)`` and its backward
is K5 (``csrc/flash_attention_bwd.cu``, one kernel per key tile, the
probabilities rebuilt from the lse) on the card and
``flash_backward_reference`` on the CPU. The raw launchers raise when
called with grad enabled on tensors that require it outside these
Functions, and on any shape or dtype they do not take (any dtype but bf16
and f32), so the entry points raise there on the card.

Head dims. The kernels compute heads of 64. Any head dim from 1 to 63
(the JAX entry points serve every one: their kernels those that are
multiples of 8, XLA the rest) reaches them zero-padded to 64
(``pad_heads``), with the scale ``1/sqrt(D)`` of its own D, and the output
(the gradients) sliced back (``unpad_heads``). This is exact: the zero
columns add nothing to ``q . k^T``, the padded columns of out, dq, dk and
dv come out 0, and the lse and ``rowsum(dO * O)`` do not change. It costs a
padded copy of each operand. Head dims above 64 raise on the card before
any launch; on the CPU the plain versions take any head dim.

Strides. K6's bf16 kernel reads q, k and v through TMA, which needs 16-byte
aligned bases and batch, head and row strides: an operand without them is
copied contiguous first (``_tma_ready``). K1, K4 and K5 raise on such
operands at head dim 64 (below it the padded copy is aligned).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .. import _build

MAX_SEQ = 512   # K1's whole-sequence limit, as the TPU kernel's (_MAX_BLOCK)
HEAD_DIM = 64   # the kernels' head dim; smaller head dims are padded to it

# Kernel launches since the last reset, counted where each kernel is launched:
# "attention" is K1, "flash" is K4, "flash_bwd" is K5 (its kernels, one
# call), "short" is K6.
launch_counts = {"attention": 0, "flash": 0, "flash_bwd": 0, "short": 0}

# The plain flash version holds [B, heads, Sq, Sk] f32 logits: it runs a few
# heads at a time so that one chunk stays near this many elements (1 GiB).
_PLAIN_CHUNK_ELEMENTS = 1 << 28


def _scale_log2(d: int) -> float:
    """The kernels' logit scale for head dim d: ``log2(e) / sqrt(d)``."""
    return math.log2(math.e) / math.sqrt(d)


def pad_heads(t, num_heads: int):
    """``[B, S, H*D]`` -> ``[B, S, H*64]``: each head's D values, then zeros
    (a new tensor; ``t`` itself at D = 64)."""
    b, s, hd = t.shape
    d = hd // num_heads
    if d == HEAD_DIM:
        return t
    return F.pad(t.reshape(b, s, num_heads, d), (0, HEAD_DIM - d)).reshape(
        b, s, num_heads * HEAD_DIM)


def unpad_heads(t, num_heads: int, d: int):
    """``[B, S, H*64]`` -> ``[B, S, H*D]``: the first d values of each head
    (``pad_heads`` undone; ``t`` itself at D = 64)."""
    if d == HEAD_DIM:
        return t
    b, s, _ = t.shape
    return t.view(b, s, num_heads, HEAD_DIM)[..., :d].reshape(b, s, num_heads * d)


def _acc(t) -> torch.dtype:
    """The plain versions' arithmetic dtype for t: f32, or f64 for f64
    input (the f64 checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scaled(logits, d: int, scale: float | None):
    """The plain versions' logits: divided by ``sqrt(d)``, or times an
    explicit ``scale`` (a head zero-padded to 64 keeps its own D's)."""
    return logits / math.sqrt(d) if scale is None else logits * scale


def attention_reference(q, k, v, num_heads: int, scale: float | None = None):
    """Plain softmax attention on ``[B, S, H*D]`` tensors (the JAX package's
    ``_attn_reference``): f32 logits times ``scale`` (``1/sqrt(D)`` unless
    given), f32 softmax, probs cast to v's dtype, f32 accumulation of p . v,
    output in v's dtype."""
    b, s, hd = q.shape
    d = hd // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, d).to(_acc(q))

    logits = _scaled(torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k)), d, scale)
    probs = torch.softmax(logits, dim=-1).to(v.dtype).to(_acc(q))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, heads(v))
    return out.reshape(b, s, hd).to(v.dtype)


def short_attention_reference(q, k, v, scale: float | None = None):
    """Plain version of K6 (the JAX package's ``_short_kernel``) on q, k, v
    ``[B, H, S, D]``: f32 logits scaled by ``scale`` (``1/sqrt(D)`` unless
    given), ``p = exp(s - max)`` and its row sum in f32, p divided by the
    sum in f32 and only then cast to v's dtype, f32 accumulation of
    ``p . v``, output in q's dtype ``[B, H, S, D]``."""
    ct = _acc(q)
    logits = _scaled(torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)), q.shape[-1], scale)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(ct), v.to(ct)).to(q.dtype)


def flash_reference(q, k, v, num_heads: int, seq_len_k: int | None = None,
                    scale: float | None = None):
    """Plain version of K4 (the JAX package's ``_flash_kernel``) on q
    ``[B, Sq, H*D]`` over k/v ``[B, Sk, H*D]``: q/k/v taken as f32, f32
    logits times ``scale`` (``1/sqrt(D)`` unless given), keys at or past
    ``seq_len_k`` masked, f32 softmax and f32 ``p . v``. Returns ``out [B,
    Sq, H*D]`` in q's dtype and the row log-sum-exp ``lse [B, H, Sq]`` f32
    (natural log)."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    seq_len_k = sk if seq_len_k is None else seq_len_k

    def heads(t, h0, h1):
        return t[..., h0 * d:h1 * d].reshape(b, t.shape[1], h1 - h0, d).to(_acc(q))

    step = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, b * sq * sk))
    outs, lses = [], []
    for h0 in range(0, num_heads, step):
        h1 = min(num_heads, h0 + step)
        logits = _scaled(torch.einsum("bqhd,bkhd->bhqk", heads(q, h0, h1),
                                      heads(k, h0, h1)), d, scale)
        if seq_len_k < sk:
            logits[..., seq_len_k:] = -math.inf
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.exp(logits - lse[..., None])
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, heads(v, h0, h1)))
        lses.append(lse)
        del logits, probs
    out = torch.cat(outs, dim=2).reshape(b, sq, hd).to(q.dtype)
    return out, torch.cat(lses, dim=1)


def flash_backward_reference(q, k, v, out, lse, dout, num_heads: int,
                             seq_len_k: int | None = None, scale: float | None = None):
    """Plain version of K5 (the JAX package's ``_bwd_dkdv_kernel`` and
    ``_bwd_dq_kernel``): the gradients of ``flash_reference`` from its saved
    ``out`` and ``lse``. f32 math, ``scale`` ``1/sqrt(D)`` unless given:
    ``p = exp(q.k^T*scale - lse)`` with keys at or past ``seq_len_k``
    masked, ``delta = rowsum(dO*O)``, ``dS = p*(dO.v^T - delta)*scale``,
    ``dV = p^T.dO``, ``dK = dS^T.q``, ``dQ = dS.k``. Chunked over heads as
    ``flash_reference`` is. With
    ``lse=None`` the row log-sum-exp is recomputed from the logits: that is
    K1's backward, the plain recompute of the JAX package's
    ``_bshd_bwd_rule``. Returns ``(dq, dk, dv)`` in the dtypes of q, k and
    v."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    seq_len_k = sk if seq_len_k is None else seq_len_k
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    delta = _delta(out, dout, num_heads)

    def heads(t, h0, h1):
        return t[..., h0 * d:h1 * d].reshape(b, t.shape[1], h1 - h0, d).to(_acc(q))

    step = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, b * sq * sk))
    dqs, dks, dvs = [], [], []
    for h0 in range(0, num_heads, step):
        h1 = min(num_heads, h0 + step)
        qh, kh, vh, gh = (heads(t, h0, h1) for t in (q, k, v, dout))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        if seq_len_k < sk:
            logits[..., seq_len_k:] = -math.inf
        rows = torch.logsumexp(logits, dim=-1) if lse is None else lse[:, h0:h1]
        p = torch.exp(logits - rows[..., None])
        del logits
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, gh))
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", gh, vh) - delta[:, h0:h1, :, None]) * scale
        del p
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, kh))
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qh))
        del ds
    return tuple(torch.cat(g, dim=2).reshape(b, -1, hd).to(t.dtype)
                 for g, t in ((dqs, q), (dks, k), (dvs, v)))


def flash_attention(q, k, v, num_heads: int, seq_len_k: int | None = None):
    """K4: q ``[B, Sq, H*D]`` over k/v ``[B, Sk, H*D]`` (any row stride), keys
    at or past ``seq_len_k`` masked -> ``(out [B, Sq, H*D], lse [B, H, Sq])``.
    The counterpart of ``flash_cross_attention`` / ``_long_forward``.
    Differentiable in q, k and v: the backward is K5 (or its plain version
    on the CPU)."""
    _device_type(q, k, v)
    return _FlashAttention.apply(q, k, v, num_heads, seq_len_k)


def flash_backward(q, k, v, out, lse, dout, num_heads: int, seq_len_k: int | None = None):
    """K5: the gradients ``(dq, dk, dv)`` of ``flash_attention`` from its
    saved ``out`` and ``lse`` and the output gradient ``dout``. The
    counterpart of ``_long_backward``."""
    if _device_type(q, k, v, out, lse, dout) == "cpu":
        return flash_backward_reference(q, k, v, out, lse, dout, num_heads, seq_len_k)
    return _flash_bwd_cuda(q, k, v, out, lse, dout, num_heads, seq_len_k)


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
    _device_type(q, k, v)
    return _Attention.apply(q, k, v, num_heads)


def dot_product_attention(q, k, v):
    """Softmax attention over q, k, v ``[B, H, S, D]`` (any strides) ->
    ``[B, H, S, D]``, the counterpart of ``dot_product_attention(impl=
    "flash")``. Up to 512 tokens: K6 on the card (``short_attention_reference``
    on the CPU), with the plain f32 recompute backward. Above: K4 with K5 as
    its backward (their plain versions on the CPU), after the change of
    layout to ``[B, S, H*D]``. Differentiable in q, k and v."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"dot_product_attention takes q, k, v [B, H, S, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _device_type(q, k, v)
    b, h, s, d = q.shape
    if s <= MAX_SEQ:
        return _ShortAttention.apply(q, k, v)
    out = flash_attention(_token_major(q), _token_major(k), _token_major(v), h)[0]
    return out.view(b, s, h, d).transpose(1, 2)


def _token_major(t):
    """``[B, H, S, D]`` -> ``[B, S, H*D]`` (a copy unless t is a head-major
    view of such a buffer)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _delta(out, dout, num_heads: int):
    """``rowsum(dO * O)`` per head in f32 -> ``[B, H, S]`` (the JAX package
    computes it in XLA, outside its kernels)."""
    b, s, hd = out.shape
    prod = dout.to(_acc(out)) * out.to(_acc(out))
    return prod.reshape(b, s, num_heads, hd // num_heads).sum(-1).transpose(1, 2).contiguous()


class _Attention(torch.autograd.Function):
    """K1 (plain version on the CPU) with the plain recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        if q.device.type == "cpu":
            out = attention_reference(q, k, v, num_heads)
        else:
            out = _attention_cuda(q, k, v, num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*flash_backward_reference(q, k, v, out, None, dout, ctx.num_heads), None)


class _ShortAttention(torch.autograd.Function):
    """K6 (plain version on the CPU) with the plain recompute backward,
    ``flash_backward_reference`` on a ``[B, S, H*D]`` view of the heads."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out = short_attention_reference(q, k, v)
        else:
            out = _short_cuda(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        b, h, s, d = q.shape
        grads = flash_backward_reference(*map(_token_major, (q, k, v, out)), None,
                                         _token_major(dout), h)
        return tuple(g.view(b, s, h, d).transpose(1, 2) for g in grads)


class _FlashAttention(torch.autograd.Function):
    """K4 (plain version on the CPU); the backward is K5 (plain on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, seq_len_k):
        if q.device.type == "cpu":
            out, lse = flash_reference(q, k, v, num_heads, seq_len_k)
        else:
            out, lse = _flash_cuda(q, k, v, num_heads, seq_len_k)
        ctx.num_heads, ctx.seq_len_k = num_heads, seq_len_k
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_backward(q, k, v, out, lse, dout, ctx.num_heads, ctx.seq_len_k)
        return (*grads, None, None)


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
    for fn in (lib.k6_short_attention_bf16, lib.k6_short_attention_f32):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
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


@functools.lru_cache(maxsize=None)
def _flash_bwd_library():
    lib = _build.load("flash_attention_bwd")
    lib.k5_flash_bwd_bf16.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 10
                                      + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                                      + [ctypes.c_void_p])
    lib.k5_flash_bwd_f32.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 8
                                     + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                                     + [ctypes.c_void_p])
    for fn in (lib.k5_flash_bwd_bf16, lib.k5_flash_bwd_f32):
        fn.restype = ctypes.c_int
    lib.k5_error_string.argtypes = [ctypes.c_int]
    lib.k5_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name: str, q, k, v, num_heads: int, *more) -> int:
    """What K1, K4 and K5 need of q/k/v (and K5 of dO) ``[B, S, H*D]``, and
    K6 of q/k/v ``[B, H, S, D]`` (``num_heads`` 1: the last dim is D).
    Returns the head dim D."""
    ts = (q, k, v) + more
    if len({t.device for t in ts}) != 1:
        raise ValueError("q, k and v lie on different devices")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{name} takes bf16 or f32 q/k/v of one dtype, got "
                         f"{', '.join(str(t.dtype) for t in ts)}")
    hd = q.shape[-1]
    d = hd // num_heads
    if hd % num_heads or not 1 <= d <= HEAD_DIM:
        raise ValueError(f"{name} takes a head dim from 1 to {HEAD_DIM} (below {HEAD_DIM} "
                         f"zero-padded to it), got {hd}/{num_heads}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{name} needs a unit stride on the last dimension")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"{name} is launched raw with grad enabled; go through "
                         "attention_bshd / flash_attention / dot_product_attention, whose "
                         "autograd Function runs the backward")
    return d


def _check_aligned(name: str, *ts) -> None:
    """bf16 operands as the kernels read them (after padding): 16-byte
    aligned rows and base pointers."""
    if ts[0].dtype != torch.bfloat16:
        return
    for t in ts:
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(f"{name} bf16 needs 16-byte aligned rows "
                             "(strides multiple of 8, aligned base)")


def _tma_ready(t):
    """A bf16 ``[B, H, S, D]`` operand as K6's tensor maps take it: ``t``
    itself when its base is 16-byte aligned and every batch, head and row
    stride (of a dim longer than 1) is a positive multiple of 8 values, else
    a contiguous copy."""
    if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
            n > 1 and (st <= 0 or st % 8) for n, st in zip(t.shape[:-1], t.stride()[:-1]))):
        return t.contiguous()
    return t


def _attention_cuda(q, k, v, num_heads: int):
    b, s, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"K1 takes 1 <= S <= {MAX_SEQ}, got S={s}")
    d = _check_operands("K1", q, k, v, num_heads)
    q, k, v = (pad_heads(t, num_heads) for t in (q, k, v))
    _check_aligned("K1", q, k, v)

    lib = _library()
    fn = lib.k1_attention_bf16 if q.dtype == torch.bfloat16 else lib.k1_attention_f32
    out = torch.empty((b, s, num_heads * HEAD_DIM), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), b, s, num_heads, _scale_log2(d), stream)
    if err != 0:
        raise RuntimeError(f"K1 attention launch failed: "
                           f"{lib.k1_error_string(err).decode()} ({err})")
    launch_counts["attention"] += 1
    return unpad_heads(out, num_heads, d)


def _short_cuda(q, k, v):
    """Launch K6 on q, k, v ``[B, H, S, D]`` (one shape and dtype, unit
    stride on D, any batch, head and row strides: in bf16 those TMA cannot
    take are copied contiguous). Returns ``[B, H, S, D]`` contiguous in q's
    dtype."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"K6 takes q, k, v [B, H, S, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"K6 takes 1 <= S <= {MAX_SEQ}, got S={s}")
    _check_operands("K6", q, k, v, 1)
    if d != HEAD_DIM:  # zero-padded heads
        q, k, v = (F.pad(t, (0, HEAD_DIM - d)) for t in (q, k, v))
    q, k, v = (_tma_ready(t) for t in (q, k, v))

    lib = _library()
    fn = lib.k6_short_attention_bf16 if q.dtype == torch.bfloat16 else lib.k6_short_attention_f32
    out = torch.empty((b, h, s, HEAD_DIM), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, s, h, _scale_log2(d),
                 stream)
    if err != 0:
        raise RuntimeError(f"K6 short attention launch failed: "
                           f"{lib.k1_error_string(err).decode()} ({err})")
    launch_counts["short"] += 1
    return out if d == HEAD_DIM else out[..., :d].contiguous()


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
    d = _check_operands("K4", q, k, v, num_heads)
    q, k, v = (pad_heads(t, num_heads) for t in (q, k, v))
    _check_aligned("K4", q, k, v)

    lib = _flash_library()
    fn = lib.k4_flash_bf16 if q.dtype == torch.bfloat16 else lib.k4_flash_f32
    out = torch.empty((b, sq, num_heads * HEAD_DIM), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), b, sq, sk, seq_len_k, num_heads,
                 _scale_log2(d), stream)
    if err != 0:
        raise RuntimeError(f"K4 flash attention launch failed: "
                           f"{lib.k4_error_string(err).decode()} ({err})")
    launch_counts["flash"] += 1
    return unpad_heads(out, num_heads, d), lse


def _flash_bwd_cuda(q, k, v, out, lse, dout, num_heads: int, seq_len_k: int | None):
    b, sq, hd = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd or \
            out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"K5 takes q, out, dO [B, Sq, H*D] and k, v [B, Sk, H*D], got "
                         f"{tuple(q.shape)}, {tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if lse.shape != (b, num_heads, sq) or lse.dtype != torch.float32:
        raise ValueError(f"K5 takes K4's f32 lse [B, H, Sq], got {lse.dtype} {tuple(lse.shape)}")
    seq_len_k = sk if seq_len_k is None else seq_len_k
    if not 1 <= seq_len_k <= sk:
        raise ValueError(f"K5 takes 1 <= seq_len_k <= Sk, got {seq_len_k}, Sk={sk}")
    if dout.stride(-1) != 1 or dout.stride(1) != hd or dout.data_ptr() % 16:
        dout = dout.contiguous()
    d = _check_operands("K5", q, k, v, num_heads, dout)
    if out.dtype != q.dtype:
        raise ValueError(f"K5 takes K4's output in q's dtype, got {out.dtype} and {q.dtype}")
    lse = lse.contiguous()
    q, k, v, out, dout = (pad_heads(t, num_heads) for t in (q, k, v, out, dout))
    _check_aligned("K5", q, k, v, dout)
    hd = num_heads * HEAD_DIM

    lib = _flash_bwd_library()
    dq = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
               dout.stride(0), dout.stride(1))
    scales = (_scale_log2(d), 1.0 / math.sqrt(d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.bfloat16:
            # scratch: the lse in log2 units and delta, padded to whole
            # 64-row tiles, and the f32 sum of dQ over the key tiles
            if out.stride(-1) != 1 or out.stride(1) % 8 or out.data_ptr() % 16:
                out = out.contiguous()
            ws = torch.empty(2 * b * num_heads * (-(-sq // 64) * 64), dtype=torch.float32,
                             device=q.device)
            dq_acc = torch.empty((b, sq, hd), dtype=torch.float32, device=q.device)
            err = lib.k5_flash_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), ws.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *strides[:6], out.stride(0), out.stride(1), *strides[6:], b, sq,
                sk, seq_len_k, num_heads, *scales, stream)
        else:
            delta = _delta(out, dout, num_heads)
            err = lib.k5_flash_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *strides, b, sq, sk, seq_len_k, num_heads, *scales, stream)
    if err != 0:
        raise RuntimeError(f"K5 flash attention backward launch failed: "
                           f"{lib.k5_error_string(err).decode()} ({err})")
    launch_counts["flash_bwd"] += 1
    return tuple(unpad_heads(t, num_heads, d) for t in (dq, dk, dv))
