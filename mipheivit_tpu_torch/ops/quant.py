"""Post-training int8 (W8A8, dynamic activation) serving ops (PyTorch).

Counterpart of ``mipheivit_tpu/ops/quant.py``, step for step, so that the
port and the JAX package turn the same floats into the same codes:

* weights (``quantize_weight``): per output channel, symmetric, scale
  ``amax / 127`` (1.0 for an all-zero channel), codes ``clip(round(w /
  scale), -127, 127)``, rounding half to even;
* activations (``quantize_rows``): per row, on the fly, ``sx = amax / 127``
  (1 for a zero row), codes ``clip(round(x / sx))`` computed in f32 (a
  division, as in JAX);
* the int8 product accumulates in int32 and is dequantised by the rank-1
  product of the two scales, ``acc * (sx * w_scale)``; the bias is added in
  f32 and the result cast back to the input's dtype.

``int8_conv3x3`` is the fusion blocks' 3x3 / stride-1 convolution as an
im2col product: each output pixel's scale is the 3x3 max-pool (zero padding)
of the per-pixel channel amax, which equals the amax of its patch row, and
the taps are multiplied by ``1 / sx`` (a multiplication, as in JAX). The
int8 patches are written tap by tap into one preallocated ``[B*H*W, 9C]``
buffer in ``(dy, dx, c)`` order, so no f32 copy of the patches exists (at
the flagship's last fusion block, batch 64 at 256 px, one f32 tap is
1.1 GB and the int8 buffer 2.5 GB).

None of this is a Pallas kernel in the JAX package (they are XLA ops). On
the card the int32 product is ``torch._int_mm`` (cuBLASLt), whose CUDA path
takes M > 16 and K, N multiples of 8: ``int_mm`` zero-pads the operands to
that, which is exact. The quantise and dequantise passes are PyTorch
elementwise kernels, so the int32 product is written to memory and read
back once (XLA fuses it into its consumers in the JAX package).

Weights are in the port's layout: ``[out, in]`` for a linear (the JAX
``[in, out]`` transposed) and ``[out, 9C]`` for a flattened conv, or
``[out, patch_width(C)]`` with zero columns past 9C, as ``Int8Conv3x3``
keeps it. On the CPU, ``int8_matmul`` and ``int8_conv3x3`` run their plain
versions, ``int8_matmul_reference`` and ``int8_conv3x3_reference`` (the
JAX functions transcribed, their int32 product ``torch._int_mm`` on the
CPU); ``int8_matmul_padded`` and ``int8_conv3x3_padded`` are what the card
runs, and run on CPU tensors too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

QMAX = 127.0
_INF = float("inf")
# torch._int_mm on CUDA: rows of the first operand above 16, the contraction
# and the output width multiples of 8
_MIN_ROWS, _ALIGN = 17, 8
# the nine taps of a 3x3 window, in the flattened weight's order
TAPS = tuple((dy, dx) for dy in range(3) for dx in range(3))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``where(amax > 0, amax / 127, 1)``. The divisor is a tensor on
    ``amax``'s device: divided by a Python number, a CUDA tensor is
    multiplied by its reciprocal instead, one bit off the IEEE quotient
    that JAX's CPU computation and numpy give."""
    return torch.where(amax > 0, amax / amax.new_full((), QMAX), torch.ones_like(amax))


def quantize_weight(w, axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: ``w ~= w_i8 * scale``.

    ``w``: a float tensor or array, reduced over ``axis`` (the contraction
    dim: -2 for the JAX ``[..., in, out]`` layout, -1 for the port's ``[out,
    in]``); a leading stacked axis passes through. Returns ``(w_i8, scale)``,
    ``scale`` f32 without ``axis``. Runs where ``w`` lies, with the JAX
    function's arithmetic (f32, IEEE division, round half to even)."""
    w = torch.as_tensor(w).float()
    scale = _scale(torch.linalg.vector_norm(w, _INF, dim=axis, keepdim=True))
    w_i8 = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return w_i8, scale.squeeze(axis)


def row_amax(x2: torch.Tensor) -> torch.Tensor:
    """``max |x|`` of each row of ``x2 [M, K]``: ``[M, 1]`` f32."""
    return torch.linalg.vector_norm(x2, _INF, dim=-1, keepdim=True, dtype=torch.float32)


def quantize_rows(x2: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 of ``x2 [M, K]``: ``(x_i8 [M, K], sx [M, 1] f32)``,
    the codes ``clip(round(x / sx), -127, 127)`` computed in f32. ``amax``
    (``[M, 1]`` f32, default ``row_amax(x2)``) gives the rows' scale: a
    row-split layer passes the max over the whole row, of which ``x2``
    holds a slice (``parallel/sharding.py``)."""
    sx = _scale(row_amax(x2) if amax is None else amax)
    q = torch.div(x2, sx)                  # a bf16 input promotes to f32 exactly
    q.round_().clamp_(-QMAX, QMAX)
    return q.to(torch.int8), sx


def dequantize(acc: torch.Tensor, sx: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``acc.float() * (sx * w_scale)`` (+ the bias in f32), cast to ``dtype``:
    the JAX function's order of operations, each step rounded to f32 as
    there. The int32 -> f32 conversion rides in the product's kernel and
    the cast in the bias add's."""
    out = torch.mul(acc, sx * w_scale.float())
    if bias is None:
        return out.to(dtype)
    if dtype == out.dtype:
        return out.add_(bias.float())
    return torch.add(out, bias.float(), out=torch.empty_like(out, dtype=dtype))


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def patch_width(c: int) -> int:
    """The width of a 3x3 conv's int8 patches as the card's product takes
    them: 9C rounded up to a multiple of 8."""
    return _ceil(9 * c, _ALIGN)


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` in int32 through ``torch._int_mm``: ``a [M, K or K']``
    int8, ``w [N, K]`` int8, where ``K'`` is K rounded up to a multiple of 8
    (``a``'s extra columns zero). M, K and N are zero-padded to what the
    CUDA path takes and the product cut back to ``[M, N]``.

    The second operand goes in as ``w.t()``, a column-major view of the
    row-major weight, with the first operand row-major: both K-contiguous,
    the layout cuBLASLt's int8 kernels take directly. A row-major second
    operand gives the same product ~5x slower on an H100 (``chip_smoke.py``'s
    ``[int8 ops]`` times both)."""
    m, n, k = a.shape[0], w.shape[0], w.shape[1]
    kp = _ceil(k, _ALIGN)
    if a.shape[1] not in (k, kp):
        raise ValueError(f"int_mm: a has {a.shape[1]} columns for a contraction of {k}")
    if a.shape[1] != kp:
        a = F.pad(a, (0, kp - k))
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))
    np_ = _ceil(n, _ALIGN)
    if kp != k or np_ != n:
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a, w.t())
    return acc[:m, :n] if (m < _MIN_ROWS or np_ != n) else acc


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ dequant(w_i8).T (+ bias)`` with dynamic per-row activation
    quantization (the JAX ``int8_matmul``).

    x: ``[..., K]`` float; w_i8: ``[N, K]`` int8; w_scale: ``[N]`` f32; bias
    ``[N]``. Returns ``[..., N]`` in x's dtype. On the card the int32
    product is ``torch._int_mm`` on padded operands (``int8_matmul_padded``);
    on the CPU the plain version runs."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_i8, w_scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on the card or the CPU, not {x.device}")
    return int8_matmul_padded(x, w_i8, w_scale, bias)


def int8_matmul_padded(x, w_i8, w_scale, bias=None):
    """``int8_matmul`` through ``int_mm``: what the card runs."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_i8, sx = quantize_rows(x.reshape(-1, k))
    acc = int_mm(x_i8, w_i8)
    return dequantize(acc, sx, w_scale, bias, x.dtype).reshape(*lead, -1)


def int8_matmul_reference(x, w_i8, w_scale, bias=None):
    """The plain version (CPU): the JAX function transcribed, its int32
    product ``torch._int_mm`` on the CPU, which takes any shape."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_i8, sx = quantize_rows(x.reshape(-1, k))
    acc = torch._int_mm(x_i8, w_i8.t().contiguous())
    return dequantize(acc, sx, w_scale, bias, x.dtype).reshape(*lead, -1)


def pixel_scales(x: torch.Tensor) -> torch.Tensor:
    """``sx [B, H, W]`` f32 of an NCHW map: the 3x3 max-pool of the per-pixel
    channel amax. max_pool2d pads with -inf where JAX pads with 0; every
    window holds its own pixel, whose amax is >= 0, so the two agree."""
    m = torch.linalg.vector_norm(x, _INF, dim=1, dtype=torch.float32)        # [B, H, W]
    return _scale(F.max_pool2d(m[:, None], 3, stride=1, padding=1)[:, 0])


def quantize_patches(x: torch.Tensor, width: Optional[int] = None):
    """The int8 im2col patches of an NCHW map for a 3x3 / stride-1 conv:
    ``(patches [B*H*W, width] int8, sx [B*H*W, 1] f32)``, columns in ``(dy,
    dx, c)`` order and zero past 9C (``width`` defaults to 9C). Each tap is
    ``clip(round(x_tap * (1 / sx)))`` in f32, written into the buffer
    before the next is made."""
    b, c, h, w = x.shape
    width = 9 * c if width is None else width
    sx = pixel_scales(x)
    inv = torch.reciprocal(sx)[..., None]                                    # [B, H, W, 1]
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))                   # NHWC, zero border
    patches = torch.empty((b, h, w, width), dtype=torch.int8, device=x.device)
    if width > 9 * c:
        patches[..., 9 * c:] = 0
    for t, (dy, dx) in enumerate(TAPS):
        q = torch.mul(xp[:, dy:dy + h, dx:dx + w], inv)
        q.round_().clamp_(-QMAX, QMAX)
        patches[..., t * c:(t + 1) * c] = q
    return patches.view(b * h * w, width), sx.reshape(-1, 1)


def int8_conv3x3(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 W8A8 convolution as an int8 im2col product (the JAX
    ``int8_conv3x3``), without bias.

    x: ``[B, C, H, W]`` float (any memory format); w_i8: ``[K, 9C]`` int8 in
    ``(dy, dx, c)`` order (``models.mipheivit.flatten_conv3x3_weight``), or
    ``[K, patch_width(C)]`` with zero columns past 9C; w_scale: ``[K]`` f32.
    Returns ``[B, K, H, W]`` in x's dtype, channels_last in memory. On the
    card ``int8_conv3x3_padded``; on the CPU the plain version."""
    if x.device.type == "cpu":
        return int8_conv3x3_reference(x, w_i8, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3 runs on the card or the CPU, not {x.device}")
    return int8_conv3x3_padded(x, w_i8, w_scale)


def int8_conv3x3_padded(x, w_i8, w_scale):
    """``int8_conv3x3`` with the patches' width padded to a multiple of 8 for
    ``int_mm``: what the card runs."""
    b, c, h, w = x.shape
    patches, sx = quantize_patches(x, patch_width(c))
    acc = int_mm(patches, w_i8)
    out = dequantize(acc, sx, w_scale, None, x.dtype)
    return out.view(b, h, w, -1).permute(0, 3, 1, 2)


def int8_conv3x3_reference(x, w_i8, w_scale):
    """The plain version (CPU): the JAX function transcribed on NHWC (zero
    padding, the nine shifted windows' max, the f32 taps concatenated), its
    int32 product ``torch._int_mm`` on the CPU."""
    b, c, h, w = x.shape
    xh = x.permute(0, 2, 3, 1)
    m = xh.float().abs().amax(dim=-1)                                         # [B, H, W]
    mp = F.pad(m, (1, 1, 1, 1))
    win = torch.stack([mp[:, dy:dy + h, dx:dx + w] for dy, dx in TAPS]).amax(dim=0)
    sx = _scale(win)
    inv = (1.0 / sx)[..., None]
    xp = F.pad(xh, (0, 0, 1, 1, 1, 1))
    taps = [torch.clamp(torch.round(xp[:, dy:dy + h, dx:dx + w].float() * inv),
                        -QMAX, QMAX).to(torch.int8) for dy, dx in TAPS]
    patches = torch.cat(taps, dim=-1).reshape(b * h * w, 9 * c)
    acc = torch._int_mm(patches, w_i8[:, :9 * c].t().contiguous())
    out = acc.float() * (sx.reshape(-1, 1) * w_scale[None, :].float())
    return out.reshape(b, h, w, -1).to(x.dtype).permute(0, 3, 1, 2)
