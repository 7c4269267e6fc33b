"""Fused SwiGLU fc1 for the ViT MLP (K2) and the fused LayerNorm + matmul
(K7): the CUDA kernels and their plain twins, with autograd.

``swiglu_fc1(x, w, b)`` computes ``silu(x @ W1^T + b1) * (x @ W2^T + b2)``
where ``w`` is the packed ``nn.Linear`` weight ``[2H, K]`` (rows ``[0, H)``
the value half W1, rows ``[H, 2H)`` the gate half W2) and ``b`` its bias
``[2H]`` (counterpart of ``mipheivit_tpu/ops/mlp.py::swiglu_fc1``). With
``ln=(scale, bias)`` a LayerNorm over the last axis runs first, with f32 row
statistics and the normed rows rounded to x's dtype, as the JAX package's
``_ln_rows`` does.

Dispatch is by device. A CPU tensor runs ``swiglu_reference``; a CUDA
tensor launches K2 (``csrc/swiglu.cu``) or raises. There is no fallback from
the kernel to the plain version. Both compute the kernel's function: f32
accumulation, f32 biases and gate, one rounding to x's dtype (not the chain
that rounds fc1's output before the gate).

Training. ``swiglu_fc1`` runs inside a ``torch.autograd.Function``, as the
JAX package's ``custom_vjp`` does. The backward is the formula of
``_swiglu_bwd_rule``: ``a`` and ``g`` are recomputed by one matmul in the
input's dtype (on the card, cuBLAS on the tensor cores with f32
accumulation); the elementwise terms ``da = dh*g*(s + silu*(1-s))`` and
``dg = dh*silu`` are formed in f32 and rounded once to the input's dtype
(``swiglu_gate_grad``: on the card one pass of K2's second entry point,
``launch_counts["swiglu_bwd"]``; its plain version ``swiglu_bwd_reference``
on the CPU); ``dx``, ``dW`` and ``db`` are computed only where the inputs
need them (the encoder is frozen: ``dx`` alone). The JAX rule's f32
matmuls are not copied: without TF32 they would run on the CUDA cores. The
LayerNorm variant backpropagates through the plain LayerNorm. The raw
launchers refuse tensors that need grad while grad is enabled.

Widths. The kernels take K, H and N that are multiples of 8 (TMA moves rows
of 16 bytes). On the card the forward zero-pads other widths to the next
multiple of 8 (``pad_swiglu``, ``pad_ln_matmul``): zero columns of x and of
W, zero LayerNorm scale and bias on those columns (so a padded column
normalises to exactly 0, with the row statistics taken over the true width),
zero weight rows and bias for the padded output columns (each half of K2's
packed weight padded on its own); the output is sliced back. The backward
runs on the unpadded tensors. The plain versions take the same ``width``
argument, so the padded route runs on the CPU too.

``ln_matmul(x, lns, lnb, w, b)`` computes ``LayerNorm(x) @ w^T + b`` with
``w`` the ``nn.Linear`` weight ``[N, K]`` (counterpart of
``mipheivit_tpu/ops/mlp.py::ln_matmul``, whose ``w`` is ``[K, N]``): the LN
rows rounded to x's dtype, f32 accumulation and bias, one rounding. On the
card K7 (the third entry point of ``csrc/swiglu.cu``, K2's kernel with the
LayerNorm and a plain epilogue), on the CPU ``ln_matmul_reference``. Its
backward is the vjp of the plain chain, the counterpart of
``_ln_matmul_bwd_rule``.

The plain versions' f32 arithmetic is f64 for f64 operands (the f64 checks
of the training step).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build
from .attention import _acc

# K2 launches since the last reset (the forward, and the backward's
# elementwise terms) and K7's ("ln_matmul"), counted where each is launched
launch_counts = {"swiglu": 0, "swiglu_bwd": 0, "ln_matmul": 0}


def ln_rows(x, scale, bias, eps: float, width: int | None = None):
    """Row LayerNorm with f32 statistics (mean, then the mean of squared
    deviations), rounded to x's dtype (the JAX package's ``_ln_rows``).
    With ``width`` the statistics run over each row's first ``width`` values
    only: the rest is zero padding (with zero scale and bias it normalises
    to exactly 0)."""
    xf = x.to(_acc(x))
    xs = xf if width is None else xf[..., :width]
    mean = xs.mean(-1, keepdim=True)
    var = (xs - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(xf.dtype) + bias.to(xf.dtype)).to(x.dtype)


def padded_width(n: int) -> int:
    """The width the kernels take for ``n``: the next multiple of 8, at
    least 8 (TMA moves rows of 16 bytes)."""
    return max(8, -(-n // 8) * 8)


def pad_swiglu(x, w, b, ln=None):
    """K2's operands zero-padded to widths its kernel takes: x ``[..., K]``
    (and the LayerNorm's scale and bias) to ``padded_width(K)`` columns;
    each half of the packed ``w [2H, K]`` to ``padded_width(H)`` rows (the
    gate half then starts at that row) and the padded K columns; each half
    of ``b`` likewise. The padded output columns are ``silu(0) * 0 = 0``.
    Operands at kernel widths come back as they are."""
    k, h = x.shape[-1], w.shape[0] // 2
    dk, dh = padded_width(k) - k, padded_width(h) - h
    if dk:
        x = F.pad(x, (0, dk))
        if ln is not None:
            ln = tuple(F.pad(t, (0, dk)) for t in ln)
    if dk or dh:
        w = F.pad(w.reshape(2, h, k), (0, dk, 0, dh)).reshape(2 * (h + dh), k + dk)
        b = F.pad(b.reshape(2, h), (0, dh)).reshape(2 * (h + dh))
    return x, w, b, ln


def pad_ln_matmul(x, lns, lnb, w, b):
    """K7's operands zero-padded to widths its kernel takes: x ``[..., K]``
    and the LayerNorm's scale and bias to ``padded_width(K)`` columns, ``w
    [N, K]`` to ``padded_width(N)`` rows and the padded K columns, ``b`` to
    ``padded_width(N)``. The padded output columns are exactly 0. Operands
    at kernel widths come back as they are."""
    k, n = x.shape[-1], w.shape[0]
    dk, dn = padded_width(k) - k, padded_width(n) - n
    if dk:
        x, lns, lnb = (F.pad(t, (0, dk)) for t in (x, lns, lnb))
    if dk or dn:
        w = F.pad(w, (0, dk, 0, dn))
        b = F.pad(b, (0, dn))
    return x, lns, lnb, w, b


def swiglu_reference(x, w, b, ln=None, eps: float = 1e-6, width: int | None = None):
    """Plain version of K2 (the JAX package's ``_swiglu_kernel``): x
    ``[..., K]``, packed ``w [2H, K]``, ``b [2H]`` -> ``[..., H]``. The
    (optionally LayerNormed) input and the weights taken as f32, f32 products
    and biases, ``a * sigmoid(a) * g`` in f32, one rounding to x's dtype.
    ``width``: the LayerNorm's statistics over the first ``width`` columns
    (``ln_rows``), for operands padded by ``pad_swiglu``."""
    h = w.shape[0] // 2
    if ln is not None:
        x = ln_rows(x, ln[0], ln[1], eps, width)
    ct = _acc(x)
    xf, wf, bf = x.to(ct), w.to(ct), b.to(ct)
    a = F.linear(xf, wf[:h], bf[:h])
    g = F.linear(xf, wf[h:], bf[h:])
    return (a * torch.sigmoid(a) * g).to(x.dtype)


def swiglu_fc1(x, w, b, *, ln=None, eps: float = 1e-6):
    """``silu(x @ W1^T + b1) * (x @ W2^T + b2)`` with W1 | W2 the packed
    ``w [2H, K]``: K2 on the card (any K and H, padded to multiples of 8),
    ``swiglu_reference`` on the CPU. Differentiable in x, w, b (and the
    LayerNorm's scale and bias). w and b are cast to x's dtype, as the JAX
    package casts them."""
    k = x.shape[-1]
    h = w.shape[0] // 2
    if w.dim() != 2 or w.shape != (2 * h, k) or b.shape != (2 * h,):
        raise ValueError(f"swiglu_fc1 takes x [..., K], w [2H, K] and b [2H], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    lns, lnb = (None, None) if ln is None else ln
    _device_type(x, w, b, *(t for t in (lns, lnb) if t is not None))
    out = _SwiGLU.apply(x.reshape(-1, k), w.to(x.dtype), b.to(x.dtype), lns, lnb, eps)
    return out.reshape(*x.shape[:-1], h)


class _SwiGLU(torch.autograd.Function):
    """K2 (plain version on the CPU) with the recompute backward."""

    @staticmethod
    def forward(ctx, x, w, b, lns, lnb, eps):
        ln = None if lns is None else (lns, lnb)
        if x.device.type == "cpu":
            out = swiglu_reference(x, w, b, ln, eps)
        else:
            out = _swiglu_card(x, w, b, ln, eps)
        ctx.eps = eps
        ctx.save_for_backward(x, w, b, lns, lnb)
        return out

    @staticmethod
    def backward(ctx, dh):
        x, w, b, lns, lnb = ctx.saved_tensors
        need_x, need_w, need_b, need_s, need_lb = ctx.needs_input_grad[:5]
        xn = x
        if lns is not None:
            with torch.enable_grad():
                x_in = x.detach().requires_grad_(need_x)
                s_in = lns.detach().requires_grad_(need_s)
                lb_in = lnb.detach().requires_grad_(need_lb)
                xn = ln_rows(x_in, s_in, lb_in, ctx.eps)
        ag = F.linear(xn.detach(), w, b)           # input dtype, f32 accumulation
        dc = swiglu_gate_grad(ag, dh)              # da | dg [M, 2H], input dtype
        del ag
        dx = dw = db = ds = dlb = None
        if need_w:
            dw = (dc.t() @ xn.detach()).to(w.dtype)
        if need_b:
            db = dc.sum(0, dtype=_acc(dc)).to(b.dtype)
        if lns is None:
            if need_x:
                dx = dc @ w
        elif need_x or need_s or need_lb:
            wanted = [t for t, need in ((x_in, need_x), (s_in, need_s), (lb_in, need_lb)) if need]
            grads = iter(torch.autograd.grad(xn, wanted, dc @ w))
            dx = next(grads) if need_x else None
            ds = next(grads) if need_s else None
            dlb = next(grads) if need_lb else None
        return dx, dw, db, ds, dlb, None


def swiglu_bwd_reference(ag, dh):
    """Plain version of the backward's elementwise terms (the JAX package's
    ``_swiglu_bwd_rule``): from the recomputed ``ag = a | g [M, 2H]`` and
    ``dh [M, H]``, in f32, ``da = dh*g*(s + silu*(1-s))`` and ``dg =
    dh*silu`` with ``s = sigmoid(a)``, rounded once into ``da | dg [M, 2H]``
    in ag's dtype."""
    h = dh.shape[-1]
    ct = _acc(ag)
    a, g = ag[:, :h].to(ct), ag[:, h:].to(ct)
    sig = torch.sigmoid(a)
    silu = a * sig
    dhf = dh.to(ct)
    return torch.cat([dhf * g * (sig + silu * (1.0 - sig)), dhf * silu], dim=-1).to(ag.dtype)


def ln_matmul_reference(x, lns, lnb, w, b, eps: float = 1e-6, width: int | None = None):
    """Plain version of K7 (the JAX package's ``_ln_matmul_kernel``): x
    ``[..., K]``, ``w [N, K]``, ``b [N]`` -> ``[..., N]``. ``ln_rows`` (f32
    statistics, normed rows rounded to x's dtype), then the rows and the
    weight taken as f32, f32 product and bias, one rounding to x's dtype.
    ``width``: the statistics over the first ``width`` columns, for
    operands padded by ``pad_ln_matmul``."""
    xn = ln_rows(x, lns, lnb, eps, width)
    ct = _acc(x)
    return F.linear(xn.to(ct), w.to(ct), b.to(ct)).to(x.dtype)


def ln_matmul(x, lns, lnb, w, b, eps: float = 1e-6):
    """``LayerNorm(x) @ w^T + b`` for x ``[..., K]``, ``w [N, K]``, ``b [N]``
    -> ``[..., N]``: K7 on the card (any N and K, padded to multiples of 8),
    ``ln_matmul_reference`` on the CPU. Differentiable in x, the LayerNorm's
    scale and bias, w and b. w and b are cast to x's dtype, as the JAX
    package casts them."""
    k = x.shape[-1]
    n = w.shape[0]
    if w.dim() != 2 or w.shape[1] != k or b.shape != (n,) or lns.shape != (k,) \
            or lnb.shape != (k,):
        raise ValueError(f"ln_matmul takes x [..., K], LayerNorm scale and bias [K], w [N, K] "
                         f"and b [N], got {tuple(x.shape)}, {tuple(lns.shape)}, "
                         f"{tuple(lnb.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    _device_type(x, lns, lnb, w, b)
    out = _LnMatmul.apply(x.reshape(-1, k), lns, lnb, w.to(x.dtype), b.to(x.dtype), eps)
    return out.reshape(*x.shape[:-1], n)


class _LnMatmul(torch.autograd.Function):
    """K7 (plain version on the CPU); the backward is autograd through the
    plain chain ``ln_rows(x) @ w^T + b`` in the input's dtype, as the JAX
    rule takes the vjp of ``_ln_reference(x) @ w + b``."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w, b, eps):
        if x.device.type == "cpu":
            out = ln_matmul_reference(x, lns, lnb, w, b, eps)
        else:
            out = _ln_matmul_card(x, lns, lnb, w, b, eps)
        ctx.eps = eps
        ctx.save_for_backward(x, lns, lnb, w, b)
        return out

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
            x, lns, lnb, w, b = ins
            out = F.linear(ln_rows(x, lns, lnb, ctx.eps), w, b)
        grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], dy))
        return (*(next(grads) if t.requires_grad else None for t in ins), None)


def swiglu_gate_grad(ag, dh):
    """``swiglu_bwd_reference``'s function: K2's backward entry point on the
    card, the plain version on the CPU."""
    if ag.device.type == "cpu" and dh.device.type == "cpu":
        return swiglu_bwd_reference(ag, dh)
    return _gate_bwd_cuda(ag, dh)


def _device_type(*tensors) -> str:
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"cuda"}):
        return devices.pop()
    raise ValueError(f"swiglu_fc1 and ln_matmul need their tensors all on the CPU or all on "
                     f"one CUDA device, got {sorted(devices)}")


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("swiglu")
    for fn in (lib.k2_swiglu_bf16, lib.k2_swiglu_f32, lib.k7_ln_matmul_bf16,
               lib.k7_ln_matmul_f32):
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.k2_swiglu_bwd_gate_bf16, lib.k2_swiglu_bwd_gate_f32):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p
    return lib


def _swiglu_card(x, w, b, ln, eps: float):
    """K2 on x ``[M, K]``, w ``[2H, K]`` and b ``[2H]`` at any K and H: the
    operands zero-padded to widths the kernel takes (``pad_swiglu``), the
    statistics over the true K, the output sliced back to ``[M, H]``."""
    k, h = x.shape[1], w.shape[0] // 2
    out = _swiglu_cuda(*pad_swiglu(x, w, b, ln), eps, width=k)
    return out if out.shape[1] == h else out[:, :h].contiguous()


def _swiglu_cuda(x, w, b, ln, eps: float, width: int | None = None):
    """Launch K2 on x ``[M, K]`` (unit column stride), w ``[2H, K]`` and b
    ``[2H]`` (contiguous, x's dtype), K and H multiples of 8; ``ln`` the
    LayerNorm's ``(scale, bias)`` or None, its statistics over each row's
    first ``width`` values (default K; the rest zero padding with zero scale
    and bias). Returns ``[M, H]`` in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"K2 takes x [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    h = w.shape[0] // 2
    width = k if width is None else width
    if w.shape != (2 * h, k) or b.shape != (2 * h,) or m < 1 or k % 8 or h % 8 or min(k, h) < 8 \
            or not 1 <= width <= k:
        raise ValueError(f"K2 takes x [M, K], w [2H, K], b [2H] with K and H multiples of 8, "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    _check_operands("K2", "swiglu_fc1", x, w, b, *(ln if ln is not None else ()))
    ln_w = ln_b = stats = None
    if ln is not None:
        if ln[0].shape != (k,) or ln[1].shape != (k,):
            raise ValueError(f"K2's LayerNorm takes scale and bias [K], got "
                             f"{tuple(ln[0].shape)}, {tuple(ln[1].shape)}")
        ln_w, ln_b = kernel_ln_params(*ln)
        stats = torch.empty((2, m), dtype=torch.float32, device=x.device)

    lib = _library()
    fn = lib.k2_swiglu_bf16 if x.dtype == torch.bfloat16 else lib.k2_swiglu_f32
    out = torch.empty((m, h), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), b.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in (ln_w, ln_b, stats)),
                 out.data_ptr(), m, k, h, width, eps, stream)
    if err != 0:
        raise RuntimeError(f"K2 swiglu launch failed: {lib.k2_error_string(err).decode()} ({err})")
    launch_counts["swiglu"] += 1
    return out


def kernel_ln_params(scale, bias):
    """The LayerNorm's scale and bias as the kernels (K2, K7, K8) read them:
    f32, zeros up to the next multiple of 64 (the bf16 kernels read whole
    64-deep stages), contiguous from an 8-byte aligned base (they read
    ``float2`` pairs). A caller's f32 tensor that already is all that comes
    back as it is; anything else is copied."""
    pad = -scale.shape[0] % 64
    out = []
    for t in (scale, bias):
        t = t.detach().float()
        if pad:
            t = F.pad(t, (0, pad))
        elif not t.is_contiguous() or t.data_ptr() % 8:
            t = t.clone(memory_format=torch.contiguous_format)
        out.append(t)
    return tuple(out)


def _check_operands(name: str, entry: str, x, w, b, *more) -> None:
    """What K2 and K7 need of x ``[M, K]``, w and b (shapes aside) and of
    the LayerNorm's scale and bias ``more``."""
    ts = (x, w, b) + more
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}'s operands lie on different devices")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError(f"{name} takes bf16 or f32 x, w and b of one dtype, got "
                         f"{x.dtype}, {w.dtype}, {b.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"{name} is launched raw with grad enabled; go through {entry}, "
                         "whose autograd Function runs the backward")
    if x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"{name} needs x with a unit column stride, got strides {x.stride()}")
    if not w.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"{name} needs contiguous w and b")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or x.stride(0) % 8 or w.data_ptr() % 16):
        raise ValueError(f"{name} bf16 needs 16-byte aligned rows of x and w "
                         "(row stride a multiple of 8, aligned base)")


def _ln_matmul_card(x, lns, lnb, w, b, eps: float):
    """K7 on x ``[M, K]``, w ``[N, K]`` and b ``[N]`` at any K and N: the
    operands zero-padded to widths the kernel takes (``pad_ln_matmul``), the
    statistics over the true K, the output sliced back to ``[M, N]``."""
    k, n = x.shape[1], w.shape[0]
    out = _ln_matmul_cuda(*pad_ln_matmul(x, lns, lnb, w, b), eps, width=k)
    return out if out.shape[1] == n else out[:, :n].contiguous()


def _ln_matmul_cuda(x, lns, lnb, w, b, eps: float, width: int | None = None):
    """Launch K7 on x ``[M, K]`` (unit column stride), the LayerNorm's scale
    and bias ``[K]``, w ``[N, K]`` and b ``[N]`` (contiguous, x's dtype), N
    and K multiples of 8; the statistics over each row's first ``width``
    values (default K; the rest zero padding with zero scale and bias).
    Returns ``[M, N]`` in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"K7 takes x [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    n = w.shape[0]
    width = k if width is None else width
    if w.shape != (n, k) or b.shape != (n,) or lns.shape != (k,) or lnb.shape != (k,) or m < 1:
        raise ValueError(f"K7 takes x [M, K], scale and bias [K], w [N, K] and b [N], got "
                         f"{tuple(x.shape)}, {tuple(lns.shape)}, {tuple(lnb.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if n % 8 or k % 8 or n < 8 or k < 8 or not 1 <= width <= k:
        raise ValueError(f"K7 takes N and K multiples of 8, as K2, got N={n}, K={k}")
    _check_operands("K7", "ln_matmul", x, w, b, lns, lnb)
    ln_w, ln_b = kernel_ln_params(lns, lnb)
    stats = torch.empty((2, m), dtype=torch.float32, device=x.device)

    lib = _library()
    fn = lib.k7_ln_matmul_bf16 if x.dtype == torch.bfloat16 else lib.k7_ln_matmul_f32
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), b.data_ptr(), ln_w.data_ptr(),
                 ln_b.data_ptr(), stats.data_ptr(), out.data_ptr(), m, k, n, width, eps, stream)
    if err != 0:
        raise RuntimeError(f"K7 ln_matmul launch failed: {lib.k2_error_string(err).decode()} "
                           f"({err})")
    launch_counts["ln_matmul"] += 1
    return out


def _gate_bwd_cuda(ag, dh):
    """Launch K2's backward entry point on ag ``[M, 2H]`` and dh ``[M, H]``
    (one dtype, bf16 or f32). Returns ``da | dg [M, 2H]`` in that dtype."""
    if ag.dim() != 2 or dh.dim() != 2 or ag.shape != (dh.shape[0], 2 * dh.shape[1]):
        raise ValueError(f"K2's backward takes ag [M, 2H] and dh [M, H], got "
                         f"{tuple(ag.shape)}, {tuple(dh.shape)}")
    m, h = dh.shape
    if ag.device != dh.device or ag.device.type != "cuda":
        raise ValueError(f"K2's backward takes ag and dh on one CUDA device, got "
                         f"{ag.device}, {dh.device}")
    if ag.dtype not in (torch.bfloat16, torch.float32) or dh.dtype != ag.dtype:
        raise ValueError(f"K2's backward takes bf16 or f32 ag and dh of one dtype, got "
                         f"{ag.dtype}, {dh.dtype}")
    if m < 1 or h % 8:
        raise ValueError(f"K2's backward takes M >= 1 and H a multiple of 8, got {m}, {h}")
    if torch.is_grad_enabled() and (ag.requires_grad or dh.requires_grad):
        raise ValueError("K2's backward is launched raw with grad enabled; it has no backward")
    ag, dh = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (ag, dh))
    lib = _library()
    fn = lib.k2_swiglu_bwd_gate_bf16 if ag.dtype == torch.bfloat16 else lib.k2_swiglu_bwd_gate_f32
    dc = torch.empty_like(ag)
    with torch.cuda.device(ag.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ag.data_ptr(), dh.data_ptr(), dc.data_ptr(), m, h, stream)
    if err != 0:
        raise RuntimeError(f"K2 swiglu backward launch failed: "
                           f"{lib.k2_error_string(err).decode()} ({err})")
    launch_counts["swiglu_bwd"] += 1
    return dc
