"""The CycleGAN stain normaliser's ResnetGenerator (PyTorch), the port's copy
of ``preprocessings/cycle_gan/resnet_generator.py``.

pix2pix's ResnetGenerator (c7s1-64, d128, d256, 9 ResNet blocks, u128,
u64, c7s1-3; affine-free instance norm, reflection padding), whose
checkpoints make the stain-normalised tile replicas of the augmentation
swaps (reference: src/callbacks.py:152-224). Module names are the JAX
module's (``stem``, ``down{i}``, ``res{i}.conv{1,2}``, ``up{i}``, ``head``).

The upsampling mirrors what the JAX module computes, which is not pix2pix's
``ConvTranspose2d(3, 2, 1, output_padding=1)``: it is flax's
``nn.ConvTranspose(padding="SAME")`` (no kernel flip) on the importer's
unflipped ``[kh, kw, in, out]`` view of the ``[in, out, kh, kw]`` weight.
``FlaxConvTranspose2d`` keeps that weight as stored and computes
``conv_transpose2d(x, w.flip(-2, -1), stride=2)[..., :2H, :2W]`` (the
stride-2 zero-dilated input padded (2, 1), correlated with the weight). A
pix2pix checkpoint therefore gives what the JAX normaliser gives, not what
pix2pix gives.

Forwards take NHWC in [-1, 1] and return NHWC f32 in [-1, 1]; the maps are
NCHW inside (channels_last on the card).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...models.layers import Conv2d, InstanceNorm2d


class FlaxConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(2, 2),
    padding="SAME")`` with the weight in pix2pix's ``[in, out, k, k]``
    storage, read unflipped as flax's ``[k, k, in, out]`` kernel."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        h, w = x.shape[-2:]
        y = F.conv_transpose2d(x, self.weight.to(x.dtype).flip(-2, -1), self.bias.to(x.dtype),
                               stride=2)
        return y[..., :2 * h, :2 * w]


class ResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3)
        self.conv2 = Conv2d(dim, dim, 3)
        self.norm = InstanceNorm2d()

    def forward(self, x):
        h = F.relu(self.norm(self.conv1(F.pad(x, (1, 1, 1, 1), mode="reflect"))))
        return x + self.norm(self.conv2(F.pad(h, (1, 1, 1, 1), mode="reflect")))


class ResnetGenerator(nn.Module):
    """``forward(x [B, H, W, 3])`` (H, W multiples of 4) -> ``[B, H, W,
    out_channels]``, tanh."""

    def __init__(self, ngf: int = 64, n_blocks: int = 9, out_channels: int = 3):
        super().__init__()
        self.ngf, self.n_blocks = ngf, n_blocks
        self.stem = Conv2d(3, ngf, 7)
        self.down0 = Conv2d(ngf, ngf * 2, 3, 2, 1)
        self.down1 = Conv2d(ngf * 2, ngf * 4, 3, 2, 1)
        for i in range(n_blocks):
            self.add_module(f"res{i}", ResnetBlock(ngf * 4))
        self.up0 = FlaxConvTranspose2d(ngf * 4, ngf * 2)
        self.up1 = FlaxConvTranspose2d(ngf * 2, ngf)
        self.head = Conv2d(ngf, out_channels, 7)
        self.norm = InstanceNorm2d()

    def forward(self, x):
        h = x.to(self.stem.weight.dtype).permute(0, 3, 1, 2)
        if h.is_cuda:
            h = h.contiguous(memory_format=torch.channels_last)
        h = F.relu(self.norm(self.stem(F.pad(h, (3, 3, 3, 3), mode="reflect"))))
        for conv in (self.down0, self.down1):
            h = F.relu(self.norm(conv(h)))
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        for up in (self.up0, self.up1):
            h = F.relu(self.norm(up(h)))
        h = self.head(F.pad(h, (3, 3, 3, 3), mode="reflect"))
        return torch.tanh(h).permute(0, 2, 3, 1).float()


def params_from_torch(state: Dict, ngf: int = 64, n_blocks: int = 9) -> Dict[str, torch.Tensor]:
    """A pix2pix / CycleGAN ``model.N.*`` Sequential state dict -> the state
    dict of ``ResnetGenerator(ngf, n_blocks)``. The counterpart of
    ``params_from_torch``: 1 is the stem conv, 4 and 7 the down convs, 10 +
    i block i (``conv_block.{1,5}``), then the two ConvTranspose (weights as
    stored) and the head conv."""
    base = 10
    up0 = base + n_blocks
    names = {"stem": "model.1", "down0": "model.4", "down1": "model.7", "up0": f"model.{up0}",
             "up1": f"model.{up0 + 3}", "head": f"model.{up0 + 7}"}
    for i in range(n_blocks):
        names[f"res{i}.conv1"] = f"model.{base + i}.conv_block.1"
        names[f"res{i}.conv2"] = f"model.{base + i}.conv_block.5"
    return {f"{ours}.{p}": torch.as_tensor(state[f"{theirs}.{p}"])
            for ours, theirs in names.items() for p in ("weight", "bias")}


def build_generator(state: Dict, ngf: int = 64, n_blocks: int = 9, device=None) -> ResnetGenerator:
    """A ``ResnetGenerator`` with ``state`` (its own layout) loaded strictly,
    in eval mode, on ``device`` (the card unless the caller asks for the
    CPU)."""
    from ..._device import resolve_device

    model = ResnetGenerator(ngf, n_blocks)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
