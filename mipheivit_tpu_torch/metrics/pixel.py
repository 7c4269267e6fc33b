"""Pixel-level metrics: PSNR / SSIM on the (-0.9, 0.9) mIF range (PyTorch).

Counterpart of ``mipheivit_tpu/metrics/pixel.py``, which reproduces the
reference's torchmetrics ``PeakSignalNoiseRatio`` and
``StructuralSimilarityIndexMeasure`` with ``data_range=(-0.9, 0.9)``
(reference: src/models.py:35-41):

  * inputs are clamped to the range; range scalar = high - low,
  * PSNR pools the MSE over the whole epoch (sum of squared error over the
    element count),
  * SSIM uses a gaussian 11x11 / sigma 1.5 window per channel on valid
    (unpadded) windows, averaged per image, then over the epoch's images.

Images are NHWC, as in the JAX package. Everything is computed in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def psnr(pred, target, data_range: Tuple[float, float] = (-0.9, 0.9)):
    lo, hi = data_range
    mse = torch.mean((pred.float().clamp(lo, hi) - target.float().clamp(lo, hi)) ** 2)
    return 10.0 * torch.log10((hi - lo) ** 2 / mse)


def ssim_per_image(pred, target, data_range: Tuple[float, float] = (-0.9, 0.9),
                   kernel_size: int = 11, sigma: float = 1.5,
                   k1: float = 0.01, k2: float = 0.03):
    """Per-image SSIM over a batch of NHWC images -> ``[B]``."""
    lo, hi = data_range
    rng = hi - lo
    pred = pred.float().clamp(lo, hi)
    target = target.float().clamp(lo, hi)
    c = pred.shape[-1]
    g = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(pred.device)
    kh = g.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = g.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)

    def blur(x):
        # separable valid-window gaussian over H then W, per channel
        x = x.permute(0, 3, 1, 2)
        return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)

    mu_p, mu_t = blur(pred), blur(target)
    mu_pp, mu_tt, mu_pt = blur(pred * pred), blur(target * target), blur(pred * target)
    var_p = mu_pp - mu_p ** 2
    var_t = mu_tt - mu_t ** 2
    cov = mu_pt - mu_p * mu_t
    c1 = (k1 * rng) ** 2
    c2 = (k2 * rng) ** 2
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return torch.mean(num / den, dim=(1, 2, 3))


def ssim(pred, target, data_range: Tuple[float, float] = (-0.9, 0.9), **kw):
    """Batch-mean SSIM."""
    return torch.mean(ssim_per_image(pred, target, data_range, **kw))


@dataclasses.dataclass
class PixelMetrics:
    """Streaming accumulator of f32 scalars on the device of the batches:
    ``update`` per batch, ``compute`` at the end (no host sync in between)."""

    sse: torch.Tensor       # sum of squared error (clamped)
    count: torch.Tensor     # element count
    ssim_sum: torch.Tensor  # sum of per-image SSIM
    images: torch.Tensor    # valid-image count (torchmetrics pools per image)

    @classmethod
    def zeros(cls, device=None) -> "PixelMetrics":
        """All sums 0 on ``device``: the card unless the CPU is asked for
        (``resolve_device``; raises without a card)."""
        device = resolve_device(device)

        def z():
            return torch.zeros((), dtype=torch.float32, device=device)

        return cls(sse=z(), count=z(), ssim_sum=z(), images=z())

    @torch.no_grad()
    def update(self, pred, target, data_range: Tuple[float, float] = (-0.9, 0.9),
               mask=None) -> "PixelMetrics":
        """mask: optional ``[B]`` validity weights (padded eval batches)."""
        lo, hi = data_range
        p = pred.float().clamp(lo, hi)
        t = target.float().clamp(lo, hi)
        per_image_elems = float(np.prod(pred.shape[1:]))
        ssim_vals = ssim_per_image(pred, target, data_range)
        if mask is None:
            mask = torch.ones(pred.shape[0], dtype=torch.float32, device=pred.device)
        mask = mask.float()
        mshape = (pred.shape[0],) + (1,) * (pred.dim() - 1)
        return PixelMetrics(
            sse=self.sse + torch.sum((p - t) ** 2 * mask.reshape(mshape)),
            count=self.count + torch.sum(mask) * per_image_elems,
            ssim_sum=self.ssim_sum + torch.sum(ssim_vals * mask),
            images=self.images + torch.sum(mask),
        )

    def compute(self, data_range: Tuple[float, float] = (-0.9, 0.9)):
        lo, hi = data_range
        mse = self.sse / torch.clamp(self.count, min=1.0)
        return {
            "psnr": 10.0 * torch.log10((hi - lo) ** 2 / mse),
            "ssim": self.ssim_sum / torch.clamp(self.images, min=1.0),
        }
