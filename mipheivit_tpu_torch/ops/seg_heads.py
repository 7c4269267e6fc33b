"""The K attention-gated marker heads in one pass: the K3 CUDA kernel and its
plain twin (counterpart of ``mipheivit_tpu/ops/seg_heads.py``).

Per pixel p of the decoder's last feature map x (C channels), with the psi
BatchNorm folded into the first gate conv (``fold_heads``):

    g1    = relu(x(p) . w1eff + b1eff)              [K*C2], rounded to x's dtype
    gate  = sigmoid(g1[k*C2:(k+1)*C2] . w2[k] + b2[k])
    m     = x(p) . wm                               [9K] (tap-major: t*K + k)
    out_k = act(bf[k] + sum_t m(p + D_t)[t*K + k] * gate_k(p + D_t))

with ``D_t = (t // 3 - 1, t % 3 - 1)``. Out-of-image neighbours contribute 0
(m has no bias), which is the zero-padded 3x3 conv of the reference heads.
Matmuls take the input dtype with f32 accumulation; gate, m, the stencil and
the activation are f32, and the output is rounded once to x's dtype.

x is ``[B, C, H, W]`` in channels_last memory (the decoder's layout) and the
output ``[B, K, H, W]`` channels_last in x's dtype. A CPU tensor runs
``seg_heads_reference``; a CUDA tensor launches K3 (``csrc/seg_heads.cu``,
C = 32 channels, any number of heads, in groups of 8 inside the one launch)
or raises. K3 has no backward: training
runs the batch-statistics chain of ``models.mipheivit.BatchedSegHeads``, and
the raw launcher refuses tensors that need grad while grad is enabled.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

# K3 launches since the last reset, counted where the kernel is launched
launch_counts = {"seg_heads": 0}

_ACTIVATIONS = {None: 0, "tanh": 1, "sigmoid": 2}
_KERNEL_C, _KERNEL_C2 = 32, 16
_HEAD_GROUP = 8     # K3 runs heads in groups of 8: the weights are zero-padded to whole groups


def fold_heads(heads, dtype):
    """The weights of a ``BatchedSegHeads`` in eval mode for
    ``fused_seg_heads``: the running-statistics BatchNorm folded into
    psi-conv1 in f32, then every tensor cast to ``dtype`` (the activation
    dtype), as the JAX package folds before its kernel. Returns
    ``(w1eff [C, K*C2], b1eff [K*C2], w2 [K, C2], b2 [K], wm [C, 9K],
    bf [K])``; w1eff and wm are transposes of contiguous output-major
    tensors, the layout K3 reads, so a launch at a multiple of 8 heads
    copies nothing."""
    bn = heads.psi_bn
    mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    w1t = heads.psi_conv1.weight[:, :, 0, 0].float() * mul[:, None]
    b1eff = (heads.psi_conv1.bias.float() - bn.running_mean.float()) * mul + bn.bias.float()
    out = (w1t, b1eff, heads.psi_conv2.weight[:, :, 0, 0], heads.psi_conv2.bias,
           heads.conv_taps.weight[:, :, 0, 0], heads.conv_bias)
    w1t, b1eff, w2, b2, wmt, bf = (t.to(dtype) for t in out)
    return w1t.t(), b1eff, w2, b2, wmt.t(), bf


def seg_heads_reference(x, w1eff, b1eff, w2, b2, wm, bf, activation="tanh"):
    """Plain version of K3 (the JAX package's ``_kernel``) on x ``[B, C, H,
    W]``: f32 products of the x-dtype inputs, g1 rounded to x's dtype, f32
    gate, taps, stencil and activation, one rounding at the end. Returns
    ``[B, K, H, W]`` channels_last in x's dtype."""
    b, c, h, w = x.shape
    k = b2.shape[0]
    xf = x.permute(0, 2, 3, 1).float()                                   # [B, H, W, C]
    g1 = torch.relu(xf @ w1eff.float() + b1eff.float()).to(x.dtype).float()
    gate = torch.sigmoid((g1.reshape(b, h, w, k, -1) * w2.float()).sum(-1) + b2.float())
    m = xf @ wm.float()                                                  # [B, H, W, 9K]
    m = F.pad(m, (0, 0, 1, 1, 1, 1))
    gate = F.pad(gate, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, h, w, k), dtype=torch.float32, device=x.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc += m[:, dy:dy + h, dx:dx + w, t * k:(t + 1) * k] * gate[:, dy:dy + h, dx:dx + w]
    out = _activate(acc + bf.float(), activation).to(x.dtype)
    return out.permute(0, 3, 1, 2)


def _activate(v, activation):
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(map(str, _ACTIVATIONS))}, "
                         f"got {activation!r}")
    if activation == "tanh":
        return torch.tanh(v)
    if activation == "sigmoid":
        return torch.sigmoid(v)
    return v


def fused_seg_heads(x, w1eff, b1eff, w2, b2, wm, bf, activation="tanh"):
    """The fused head chain on x ``[B, C, H, W]`` (channels_last memory):
    K3 on the card, ``seg_heads_reference`` on the CPU. Weights as
    ``fold_heads`` returns them. Returns ``[B, K, H, W]`` channels_last in
    x's dtype."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"fused_seg_heads takes x [B, C, H, W] in channels_last memory, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    ts = (x, w1eff, b1eff, w2, b2, wm, bf)
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return seg_heads_reference(x, w1eff, b1eff, w2, b2, wm, bf, activation)
    if devices != {"cuda"}:
        raise ValueError(f"fused_seg_heads needs x and the weights all on the CPU or all on "
                         f"one CUDA device, got {sorted(devices)}")
    return _seg_heads_cuda(x, w1eff, b1eff, w2, b2, wm, bf, activation)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("seg_heads")
    for fn in (lib.k3_seg_heads_bf16, lib.k3_seg_heads_f32):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.k3_error_string.argtypes = [ctypes.c_int]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib


def _padded_weights(w1eff, b1eff, w2, b2, wm, bf):
    """The kernel's layout: heads zero-padded to a multiple of 8 (KP) and
    the two matmul weights output-major (``w1t [KP*C2, C]``, ``wmt [9*KP,
    C]`` with row ``t*KP + k``), all contiguous and 16-byte aligned. Padded
    heads have zero weights, so their m is 0 and they are not stored. At a
    multiple of 8 heads with ``fold_heads``'s layout these are views, not
    copies."""
    c, kc2 = w1eff.shape
    k = b2.shape[0]
    pad = -k % _HEAD_GROUP

    def heads_first(t):       # pad the leading head axis with zeros
        return (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) if pad else t).contiguous()

    w1t = heads_first(w1eff.t().reshape(k, kc2 // k, c)).reshape(-1, c)
    b1 = heads_first(b1eff.reshape(k, -1)).reshape(-1)
    wmt = wm.t().reshape(9, k, c)
    wmt = (F.pad(wmt, (0, 0, 0, pad)) if pad else wmt).reshape(-1, c).contiguous()
    out = (w1t, b1, heads_first(w2), heads_first(b2), wmt, heads_first(bf))
    # the kernel reads weight rows 16 bytes at a time: a view at another
    # offset is copied to a fresh (aligned) tensor
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in out)


def _seg_heads_cuda(x, w1eff, b1eff, w2, b2, wm, bf, activation):
    b, c, h, w = x.shape
    k = b2.shape[0]
    ts = (x, w1eff, b1eff, w2, b2, wm, bf)
    if len({t.device for t in ts}) != 1:
        raise ValueError("K3's operands lie on different devices")
    if x.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"K3 takes bf16 or f32 x and weights of one dtype, got "
                         f"{', '.join(str(t.dtype) for t in ts)}")
    if c != _KERNEL_C or k < 1:
        raise ValueError(f"K3 takes C = {_KERNEL_C} channels and at least one head, "
                         f"got C = {c}, K = {k}")
    if (w1eff.shape != (c, k * _KERNEL_C2) or b1eff.shape != (k * _KERNEL_C2,)
            or w2.shape != (k, _KERNEL_C2) or b2.shape != (k,) or wm.shape != (c, 9 * k)
            or bf.shape != (k,)):
        raise ValueError(f"K3 takes w1eff [C, K*16], b1eff [K*16], w2 [K, 16], b2 [K], "
                         f"wm [C, 9K], bf [K], got {[tuple(t.shape) for t in ts[1:]]}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"K3 takes activation in {sorted(map(str, _ACTIVATIONS))}, "
                         f"got {activation!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("K3 has no backward; it runs with grad disabled or on tensors that "
                         "need none (training runs BatchedSegHeads' batch-statistics chain)")
    if x.data_ptr() % 16:
        raise ValueError("K3 needs a 16-byte aligned x")
    weights = _padded_weights(w1eff, b1eff, w2, b2, wm, bf)

    lib = _library()
    fn = lib.k3_seg_heads_bf16 if x.dtype == torch.bfloat16 else lib.k3_seg_heads_f32
    out = torch.empty((b, k, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
                 b, h, w, k, _ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError(f"K3 seg heads launch failed: {lib.k3_error_string(err).decode()} "
                           f"({err})")
    launch_counts["seg_heads"] += 1
    return out
