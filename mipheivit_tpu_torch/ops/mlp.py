"""Fused SwiGLU fc1 for the ViT MLP: the K2 CUDA kernel and its plain twin,
with autograd.

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
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

# K2 launches since the last reset (the forward, and the backward's
# elementwise terms), counted where the kernel is launched
launch_counts = {"swiglu": 0, "swiglu_bwd": 0}


def ln_rows(x, scale, bias, eps: float):
    """Row LayerNorm with f32 statistics (mean, then the mean of squared
    deviations), rounded to x's dtype (the JAX package's ``_ln_rows``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def swiglu_reference(x, w, b, ln=None, eps: float = 1e-6):
    """Plain version of K2 (the JAX package's ``_swiglu_kernel``): x
    ``[..., K]``, packed ``w [2H, K]``, ``b [2H]`` -> ``[..., H]``. The
    (optionally LayerNormed) input and the weights taken as f32, f32 products
    and biases, ``a * sigmoid(a) * g`` in f32, one rounding to x's dtype."""
    h = w.shape[0] // 2
    if ln is not None:
        x = ln_rows(x, ln[0], ln[1], eps)
    xf, wf, bf = x.float(), w.float(), b.float()
    a = F.linear(xf, wf[:h], bf[:h])
    g = F.linear(xf, wf[h:], bf[h:])
    return (a * torch.sigmoid(a) * g).to(x.dtype)


def swiglu_fc1(x, w, b, *, ln=None, eps: float = 1e-6):
    """``silu(x @ W1^T + b1) * (x @ W2^T + b2)`` with W1 | W2 the packed
    ``w [2H, K]``: K2 on the card, ``swiglu_reference`` on the CPU.
    Differentiable in x, w, b (and the LayerNorm's scale and bias). w and b
    are cast to x's dtype, as the JAX package casts them."""
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
            out = _swiglu_cuda(x, w, b, ln, eps)
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
            db = dc.sum(0, dtype=torch.float32).to(b.dtype)
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
    a, g = ag[:, :h].float(), ag[:, h:].float()
    sig = torch.sigmoid(a)
    silu = a * sig
    dhf = dh.float()
    return torch.cat([dhf * g * (sig + silu * (1.0 - sig)), dhf * silu], dim=-1).to(ag.dtype)


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
    raise ValueError(f"swiglu_fc1 needs x, w, b all on the CPU or all on one CUDA device, "
                     f"got {sorted(devices)}")


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("swiglu")
    for fn in (lib.k2_swiglu_bf16, lib.k2_swiglu_f32):
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.k2_swiglu_bwd_gate_bf16, lib.k2_swiglu_bwd_gate_f32):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p
    return lib


def _swiglu_cuda(x, w, b, ln, eps: float):
    """Launch K2 on x ``[M, K]`` (unit column stride), w ``[2H, K]`` and b
    ``[2H]`` (contiguous, x's dtype); ``ln`` the LayerNorm's ``(scale,
    bias)`` or None. Returns ``[M, H]`` in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"K2 takes x [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    h = w.shape[0] // 2
    ts = (x, w, b) + (tuple(ln) if ln is not None else ())
    if len({t.device for t in ts}) != 1:
        raise ValueError("K2's operands lie on different devices")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError(f"K2 takes bf16 or f32 x, w and b of one dtype, got "
                         f"{x.dtype}, {w.dtype}, {b.dtype}")
    if w.shape != (2 * h, k) or b.shape != (2 * h,) or m < 1 or k % 8 or h % 8 or h < 8:
        raise ValueError(f"K2 takes x [M, K], w [2H, K], b [2H] with K and H multiples of 8, "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("K2 is launched raw with grad enabled; go through swiglu_fc1, "
                         "whose autograd Function runs the backward")
    if x.stride(1) != 1 or x.stride(0) < k:
        raise ValueError(f"K2 needs x with a unit column stride, got strides {x.stride()}")
    if not w.is_contiguous() or not b.is_contiguous():
        raise ValueError("K2 needs contiguous w and b")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or x.stride(0) % 8 or w.data_ptr() % 16):
        raise ValueError("K2 bf16 needs 16-byte aligned rows of x and w "
                         "(row stride a multiple of 8, aligned base)")
    ln_w = ln_b = None
    if ln is not None:
        ln_w, ln_b = (t.detach().float().contiguous() for t in ln)
        if ln_w.shape != (k,) or ln_b.shape != (k,):
            raise ValueError(f"K2's LayerNorm takes scale and bias [K], got "
                             f"{tuple(ln_w.shape)}, {tuple(ln_b.shape)}")

    lib = _library()
    fn = lib.k2_swiglu_bf16 if x.dtype == torch.bfloat16 else lib.k2_swiglu_f32
    out = torch.empty((m, h), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), b.data_ptr(),
                 None if ln_w is None else ln_w.data_ptr(),
                 None if ln_b is None else ln_b.data_ptr(),
                 out.data_ptr(), m, k, h, eps, stream)
    if err != 0:
        raise RuntimeError(f"K2 swiglu launch failed: {lib.k2_error_string(err).decode()} ({err})")
    launch_counts["swiglu"] += 1
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
