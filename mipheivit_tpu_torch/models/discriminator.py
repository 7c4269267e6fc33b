"""70x70 PatchGAN discriminator with spectral normalization (PyTorch).

Counterpart of ``mipheivit_tpu/models/discriminator.py`` (reference:
``DiscriminatorPatch``, src/models.py:399-485): 4x4 convs, a stride-2
pyramid, spectral norm on every conv, LeakyReLU(0.2); the input is
concat(H&E, generated) along channels.
Images are NHWC at the public call, logits come back NHWC ``[B, h, w, 1]``,
as in JAX. Only what the reference trains with is ported: no norm layers,
no dropout. ``selected_channels`` (the structural GAN mode) discriminates
only those markers of the generated image.

Spectral norm follows the JAX power iteration exactly, which
``torch.nn.utils.spectral_norm`` does not: the persistent state is ``u``
alone. With ``update_stats`` (the discriminator's own step) one iteration
``v = n(W^T u)``, ``u = n(W v)`` runs and the new ``u`` is stored; without
it (the generator's adversarial term) ``v = n(W^T u)`` is recomputed from
the stored ``u`` and ``u`` is left alone. ``sigma = u^T W v`` with u and v
detached, ``n(x) = x / (|x| + 1e-12)``, ``W`` the weight as ``[out, -1]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _n(x):
    return x / (torch.linalg.vector_norm(x) + 1e-12)


class SpectralConv(nn.Module):
    """4x4 conv, padding 1, with a spectrally normalized weight."""

    def __init__(self, in_chans: int, features: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.randn(features, in_chans, 4, 4) * 0.02)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.randn(features))

    def forward(self, x, update_stats: bool = False):
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            wd = w_mat.detach().float()
            u = self.u
            v = _n(wd.T @ u)
            if update_stats:
                u = _n(wd @ v)
                self.u.copy_(u)
        sigma = torch.einsum("i,ij,j->", u, w_mat.float(), v)
        w_sn = self.weight / sigma
        return F.conv2d(x, w_sn.to(x.dtype), self.bias.to(x.dtype), self.stride, 1)


class DiscriminatorPatch(nn.Module):
    def __init__(self, in_chans: int, ndf: int = 64, n_layers: int = 3,
                 selected_channels: Optional[Sequence[int]] = None):
        """``in_chans``: 3 plus the number of markers discriminated (all of
        them, or ``len(selected_channels)``)."""
        super().__init__()
        self.selected_channels = None if selected_channels is None else list(selected_channels)
        chans = [in_chans] + [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        strides = [2] * n_layers + [1]
        self.convs = nn.ModuleList(
            [SpectralConv(chans[i], chans[i + 1], s) for i, s in enumerate(strides)]
            + [SpectralConv(chans[-1], 1, 1)])

    def forward(self, x, fake_images, update_stats: bool = False):
        """``x`` ``[B, H, W, 3]``, ``fake_images`` ``[B, H, W, C]`` -> logits
        ``[B, h, w, 1]``."""
        if self.selected_channels is not None:
            fake_images = fake_images[..., self.selected_channels]
        h = torch.cat([x, fake_images], dim=-1).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            h = conv(h, update_stats)
            if i < len(self.convs) - 1:
                h = F.leaky_relu(h, 0.2)
        return h.permute(0, 2, 3, 1)
