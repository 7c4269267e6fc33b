"""The plain layers the reference's encoder and decoder pieces share, and
the shapes of their tensors by the program's names.

``quant="fp8"`` is the control's precision: the operands of every product
(linears, LoRA, attention's q.k^T and p.v, convolutions) rounded to float8
e4m3 with one scale a tensor, the gradient passed straight through.
Attention runs in query chunks, so a 1024-px region fits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

ATTN_CHUNK = 1024          # query rows of one attention product


def bn_shapes(name: str, c: int) -> Dict[str, Tuple[int, ...]]:
    return {f"{name}.weight": (c,), f"{name}.bias": (c,), f"{name}.running_mean": (c,),
            f"{name}.running_var": (c,)}


def conv_shapes(name: str, cout: int, cin: int, k: int, bias: bool = True,
                transposed: bool = False):
    s = {f"{name}.weight": (cin, cout, k, k) if transposed else (cout, cin, k, k)}
    if bias:
        s[f"{name}.bias"] = (cout,)
    return s


def head_shapes(name: str, c: int) -> Dict[str, Tuple[int, ...]]:
    """One attention-gated marker head on ``c`` channels."""
    s = conv_shapes(f"{name}.0.psi.0", c // 2, c, 1)
    s.update(bn_shapes(f"{name}.0.psi.1", c // 2))
    s.update(conv_shapes(f"{name}.0.psi.3", 1, c // 2, 1))
    s.update(conv_shapes(f"{name}.1", 1, c, 3))
    return s


def _fp8_tensor(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude at 448),
    dequantised."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


_QUANT = {"fp8": _fp8_tensor}


def rounder(quant: Optional[str]):
    """The operand rounding of the products at ``quant`` (None: none), the
    gradient passed straight through."""
    if quant is None:
        return lambda t: t
    fn = _QUANT[quant]
    return lambda t: t + (fn(t) - t).detach()


def linear(x, w, b, q):
    return F.linear(q(x), q(w), b)


def conv(x, w, b, q, **kw):
    return F.conv2d(q(x), q(w), b, **kw)


def conv_t(x, w, b, q, **kw):
    return F.conv_transpose2d(q(x), q(w), b, **kw)


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], eps)


def batch_norm(x, p, name, eps: float, training: bool):
    """Eval: the running statistics. Training: flax's batch statistics,
    ``mean(x)`` and ``max(mean(x^2) - mean(x)^2, 0)``."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if not training:
        return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"], w, b,
                            False, 0.0, eps)
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * w
    return (x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]


def attention(q, k, v, heads: int, r=rounder(None)):
    """Softmax attention over ``[B, S, H*D]`` q, k, v in query chunks."""
    b, s, hd = q.shape
    d = hd // heads
    qh, kh, vh = (r(t).reshape(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
    outs = []
    for i in range(0, s, ATTN_CHUNK):
        logits = torch.matmul(qh[:, :, i:i + ATTN_CHUNK], kh.transpose(-1, -2)) / math.sqrt(d)
        outs.append(torch.matmul(r(torch.softmax(logits, dim=-1)), vh))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, hd)


def head(p, name, x, eps, training, q):
    """An attention-gated marker head: 1x1 conv, BN, ReLU, 1x1 conv, sigmoid
    gate; 3x3 conv; tanh."""
    g = conv(x, p[f"{name}.0.psi.0.weight"], p[f"{name}.0.psi.0.bias"], q)
    g = F.relu(batch_norm(g, p, f"{name}.0.psi.1", eps, training))
    g = torch.sigmoid(conv(g, p[f"{name}.0.psi.3.weight"], p[f"{name}.0.psi.3.bias"], q))
    y = conv(x * g, p[f"{name}.1.weight"], p[f"{name}.1.bias"], q, padding=1)
    return torch.tanh(y)


def conv_bn_relu(p, name, bn, x, eps, training, q, stride=1):
    y = conv(x, p[f"{name}.weight"], None, q, stride=stride, padding=1)
    return F.relu(batch_norm(y, p, bn, eps, training))
