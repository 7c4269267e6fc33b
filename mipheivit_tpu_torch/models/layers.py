"""Layers shared by the generators, with flax's arithmetic where it differs
from torch's defaults.

Every layer with weights casts them to its input's dtype at use, as the flax
modules (``nn.Conv(dtype=x.dtype)`` ...) do: a generator keeps f32
parameters and computes in bf16 when its input is bf16. ``BatchNorm2d``
computes in f32 whatever the input's dtype (in f64 for f64 input). ``Dropout`` draws its masks from
a ``torch.Generator`` that the train step hands it, never from torch's
global one.

``set_compute_dtype`` sets the dtype a generator casts its input to (None:
its parameters' dtype), the counterpart of the JAX builders' ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's arithmetic, in f32 whatever the
    activation dtype (training mode: f64 for f64 input), returning x's
    dtype.

    Eval: the running statistics (kept f32) and the f32 copy of weight and
    bias are applied by one fused kernel. Training: batch statistics
    ``mean(x)`` and ``max(mean(x^2) - mean(x)^2, 0)`` normalise the batch,
    and the running statistics move by momentum 0.1 toward them. The running
    variance takes the biased batch variance, as flax and the JAX package's
    ``BatchedSegHeads`` do (torch's own update takes the unbiased one,
    n/(n-1) larger).

    With ``sync_group`` set (``sync_batch_norm``), training statistics are
    those of the global batch: the per-channel sums of x and x^2 and the
    count are summed over the group's ranks (one all-reduce, whose backward
    sums too), as flax's BatchNorm averages over a batch axis that GSPMD
    shards."""

    sync_group = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight.float(),
                                self.bias.float(), False, 0.0, self.eps)
        ct = torch.promote_types(x.dtype, torch.float32)    # f32, or f64 in f64 checks
        xf = x.to(ct)
        if self.sync_group is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            from ..parallel.mesh import all_reduce_sum

            count = torch.full((1,), x.numel() / x.shape[1], dtype=ct, device=x.device)
            sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                             count]), self.sync_group)
            c = x.shape[1]
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight.to(ct)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(ct)[:, None, None]
        return y.to(x.dtype)


def _cast(t, x):
    return None if t is None else t.to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its weight and bias to the input's dtype at
    use (flax ``nn.Conv(dtype=x.dtype)``): trainable f32 weights, bf16
    compute."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` casting like ``Conv2d``, with its
    ``output_padding`` (the JAX package's ``ops/deconv.py``
    ``TorchConvTranspose``: the HEMIT generators' k3 s2 p1 op1 upsamples)."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` casting like ``Conv2d``."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last dim, casting like ``Conv2d``."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x),
                            _cast(self.bias, x), self.eps)


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW map (timm's ``LayerNorm2d``;
    flax's ``nn.LayerNorm`` on NHWC)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class FrozenBatchNorm2d(BatchNorm2d):
    """``BatchNorm2d`` on its running statistics in training too (flax
    ``nn.BatchNorm(use_running_average=True)``: the Swin conv stem's), in
    f32 (f64 for f64 input), returning x's dtype."""

    def forward(self, x):
        ct = torch.promote_types(x.dtype, torch.float32)
        return F.batch_norm(x.to(ct), self.running_mean.to(ct), self.running_var.to(ct),
                            self.weight.to(ct), self.bias.to(ct), False, 0.0,
                            self.eps).to(x.dtype)


class InstanceNorm2d(nn.Module):
    """Instance norm without affine parameters: per image and channel,
    ``(x - mean) / sqrt(var + 1e-5)`` with the biased variance, in f32 (the
    JAX package's ``hemit._Norm("instance")``, pix2pix's
    ``InstanceNorm2d(affine=False)``)."""

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
        return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


class Dropout(nn.Module):
    """flax's ``nn.Dropout(p)``: in training each element is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; in eval, and at
    ``p = 0``, x itself. The masks come from ``generator``, which the train
    step sets to its state's ``rng`` (``use_generator``); training mode
    without one raises rather than draw from torch's global generator."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator "
                               "(models.layers.use_generator; the train step sets it)")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def use_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every ``Dropout`` of ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Compute the training statistics of every ``BatchNorm2d`` of
    ``model`` over the global batch of ``group``'s ranks (None: each rank's
    own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
    return model


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Set the dtype ``model`` and its encoder cast their input to (None:
    the dtype of their parameters) on every module that has one."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


def pix2pix_init(module: nn.Module) -> nn.Module:
    """The reference decoders' init (src/generators/unet.py:522-531; the JAX
    package's ``conv_init`` / ``bn_scale_init``): conv and transposed-conv
    weights N(0, 0.02), biases 0, BatchNorm scale N(1, 0.02), shift 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.normal_(0.0, 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.normal_(1.0, 0.02)
                m.bias.zero_()
    return module
