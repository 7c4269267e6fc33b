"""Cellpose's CPnet (PyTorch) and its tiled whole-image evaluation.

The port's counterpart of ``mipheivit_tpu/models/cellpose_net.py``. The
network is Cellpose's CPnet (Stringer et al., Nat Methods 2021; the public
``cellpose/resnet_torch.py`` architecture), with cellpose's own module and
parameter names, so a cellpose checkpoint loads with
``load_state_dict(strict=True)``:

* ``downsample.down.res_down_{n}``: pre-activation residual levels
  (``proj`` = BN -> 1x1 conv, ``conv.conv_{0..3}`` = BN -> ReLU -> 3x3
  conv), 2x2 max pooling between levels;
* the style: the deepest map's global average, L2-normalised;
* ``upsample.up.res_up_{n}``: residual levels whose convs 1-3 add a
  ``full`` Linear of the style before their BN; nearest x2 upsampling
  between levels; the skips add;
* ``output``: BN -> ReLU -> 1x1 conv to (flow dY, flow dX, cellprob);
* ``diam_mean`` / ``diam_labels``: the diameters the model was trained at.

The forward takes NCHW and runs in eval mode: BatchNorm on its running
statistics. Convolutions, BatchNorm and the pooling are library ops (they
port XLA ops; no Pallas kernel is involved). On the card the maps are
channels_last.

``eval_flows`` runs the network over an image of any size in fixed-shape
tile batches on the model's device and blends the tiles on the host with
the JAX package's taper, tile grid and padding.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
NBASE = (2, 32, 64, 128, 256)   # cellpose's nuclei / cyto models
NOUT = 3


def _batchconv(cin: int, cout: int, sz: int) -> nn.Sequential:
    """BN -> ReLU -> conv (cellpose ``batchconv``: the conv at index 2)."""
    return nn.Sequential(nn.BatchNorm2d(cin, eps=BN_EPS, momentum=0.05), nn.ReLU(inplace=True),
                         nn.Conv2d(cin, cout, sz, padding=sz // 2))


def _batchconv0(cin: int, cout: int, sz: int) -> nn.Sequential:
    """BN -> conv (cellpose ``batchconv0``, the projections: conv at 1)."""
    return nn.Sequential(nn.BatchNorm2d(cin, eps=BN_EPS, momentum=0.05),
                         nn.Conv2d(cin, cout, sz, padding=sz // 2))


class _ResDown(nn.Module):
    def __init__(self, cin: int, cout: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.proj = _batchconv0(cin, cout, 1)
        for t in range(4):
            self.conv.add_module(f"conv_{t}", _batchconv(cin if t == 0 else cout, cout, sz))

    def forward(self, x):
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        return x + self.conv[3](self.conv[2](x))


class _BatchConvStyle(nn.Module):
    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = _batchconv(cin, cout, sz)
        self.full = nn.Linear(style_channels, cout)

    def forward(self, style, x, y=None):
        if y is not None:
            x = x + y
        return self.conv(x + self.full(style)[:, :, None, None])


class _ResUp(nn.Module):
    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("conv_0", _batchconv(cin, cout, sz))
        for t in (1, 2, 3):
            self.conv.add_module(f"conv_{t}", _BatchConvStyle(cout, cout, style_channels, sz))
        self.proj = _batchconv0(cin, cout, 1)

    def forward(self, x, y, style):
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        return x + self.conv[3](style, self.conv[2](style, x))


class _Down(nn.Module):
    def __init__(self, nbase, sz: int):
        super().__init__()
        self.down = nn.Sequential()
        for n in range(len(nbase) - 1):
            self.down.add_module(f"res_down_{n}", _ResDown(nbase[n], nbase[n + 1], sz))

    def forward(self, x) -> List[torch.Tensor]:
        xd = []
        for n, level in enumerate(self.down):
            xd.append(level(F.max_pool2d(xd[-1], 2, 2) if n else x))
        return xd


class _Up(nn.Module):
    def __init__(self, nbase, sz: int):
        super().__init__()
        self.up = nn.Sequential()
        for n in range(1, len(nbase)):
            self.up.add_module(f"res_up_{n - 1}", _ResUp(nbase[n], nbase[n - 1], nbase[-1], sz))

    def forward(self, style, xd):
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self.up[n](x, xd[n], style)
        return x


class CPnet(nn.Module):
    """Cellpose's CPnet: ``forward(x [B, nbase[0], H, W])`` (H, W multiples
    of 16) -> ``(y [B, nout, H, W], style [B, nbase[-1]])``. The
    counterpart of ``cpnet_forward``."""

    def __init__(self, nbase=NBASE, nout: int = NOUT, sz: int = 3, diam_mean: float = 30.0):
        super().__init__()
        self.nbase = tuple(nbase)
        self.downsample = _Down(self.nbase, sz)
        nbaseup = list(self.nbase[1:]) + [self.nbase[-1]]
        self.upsample = _Up(nbaseup, sz)
        self.output = _batchconv(nbaseup[0], nout, 1)
        self.register_buffer("diam_mean", torch.full((1,), float(diam_mean)))
        self.register_buffer("diam_labels", torch.full((1,), float(diam_mean)))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        xd = self.downsample(x)
        style = xd[-1].mean(dim=(2, 3))
        style = style / torch.sqrt(torch.sum(style ** 2, dim=1, keepdim=True) + 1e-12)
        return self.output(self.upsample(style, xd)), style

    @property
    def rescale(self) -> float:
        """``diam_mean / diam_labels``: the factor an image is resized by
        before the network (1 for a model without ``diam_labels``)."""
        return float(self.diam_mean) / float(self.diam_labels or self.diam_mean)


def cellpose_nbase(state) -> Tuple[int, ...]:
    """The ``nbase`` of a cellpose state dict: the input channels of the
    first projection, then each down level's output channels."""
    n_down = sum(1 for k in state if k.startswith("downsample.down.res_down_")
                 and k.endswith(".proj.1.weight"))
    w = [state[f"downsample.down.res_down_{n}.proj.1.weight"] for n in range(n_down)]
    return (int(w[0].shape[1]),) + tuple(int(t.shape[0]) for t in w)


def build_cpnet(state, device=None) -> CPnet:
    """A ``CPnet`` shaped like ``state`` (a cellpose state dict of tensors
    or arrays), loaded strictly, in eval mode, on ``device`` (the card
    unless the caller asks for the CPU)."""
    from .._device import resolve_device

    state = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}
    # checkpoints without the diameters: cellpose's 30 px, and no rescale
    state.setdefault("diam_mean", torch.full((1,), 30.0))
    state.setdefault("diam_labels", state["diam_mean"].clone())
    nout = int(state["output.2.weight"].shape[0])
    model = CPnet(cellpose_nbase(state), nout)
    model.load_state_dict(state, strict=True)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def load_cellpose_checkpoint(path, device=None) -> CPnet:
    """A cellpose checkpoint file (a CPnet state dict: a torch pickle read
    with ``weights_only=True``, or safetensors) as a ``CPnet`` on
    ``device``. The counterpart of ``load_cellpose_checkpoint``."""
    from ..infer.loading import load_state_dict

    return build_cpnet(load_state_dict(path), device)


def _taper(tile: int, edge: int) -> np.ndarray:
    """Separable cosine taper: 1 inside the tile, falling to ~0 at its
    border, so overlap-averaged tiles blend without seams."""
    r = np.ones(tile, np.float32)
    ramp = 0.5 - 0.5 * np.cos(np.linspace(0.0, np.pi, edge, dtype=np.float32))
    r[:edge] = np.maximum(ramp, 1e-3)
    r[-edge:] = np.minimum(r[-edge:], np.maximum(ramp[::-1], 1e-3))
    return np.outer(r, r)


def _starts(size: int, tile: int, stride: int) -> List[int]:
    s = list(range(0, max(size - tile, 0) + 1, stride))
    if s[-1] != size - tile:
        s.append(size - tile)
    return s


@torch.no_grad()
def eval_flows(model: CPnet, img: np.ndarray, tile: int = 224, overlap: int = 48,
               batch_size: int = 64, stats: Optional[dict] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """CPnet over a normalised image of any size. The counterpart of
    ``eval_flows``.

    ``img``: [H, W] or [H, W, 1] float32. The network's second channel is
    zero (cellpose's ``channels=[0, 0]``). Returns ``(dp [2, H, W]`` f32
    (dY, dX), ``cellprob [H, W]`` f32).

    The image is zero-padded to multiples of 16 (at least one tile), cut
    into ``tile``-px tiles every ``tile - overlap`` px (the last row and
    column flush with the edge), and the tiles run in batches of exactly
    ``batch_size`` on the model's device (the last one zero-filled). The
    outputs are blended on the host with ``_taper``. ``stats``, when given,
    accumulates ``"net_s"`` (wall seconds in the network, synchronised)
    and ``"tiles"``."""
    import time

    if img.ndim == 3:
        img = img[..., 0]
    h, w = img.shape
    ph = max(tile, int(np.ceil(h / 16.0)) * 16)
    pw = max(tile, int(np.ceil(w / 16.0)) * 16)
    padded = np.zeros((ph, pw), np.float32)
    padded[:h, :w] = img
    stride = tile - overlap
    positions = [(y, x) for y in _starts(ph, tile, stride) for x in _starts(pw, tile, stride)]

    taper = _taper(tile, max(overlap // 2, 8))
    acc = np.zeros((3, ph, pw), np.float32)
    wacc = np.zeros((ph, pw), np.float32)
    param = next(model.parameters())
    dev, cl = param.device, param.device.type == "cuda"
    batch = torch.zeros((batch_size, 2, tile, tile), dtype=torch.float32,
                        pin_memory=cl)
    for i in range(0, len(positions), batch_size):
        chunk = positions[i:i + batch_size]
        batch.zero_()
        for j, (y, x) in enumerate(chunk):
            batch[j, 0] = torch.from_numpy(padded[y:y + tile, x:x + tile])
        t0 = time.perf_counter()
        x = batch.to(dev, non_blocking=True)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        out = model(x)[0][:len(chunk)].float().cpu().numpy()
        if stats is not None:
            stats["net_s"] = stats.get("net_s", 0.0) + time.perf_counter() - t0
            stats["tiles"] = stats.get("tiles", 0) + len(chunk)
        for j, (y, x) in enumerate(chunk):
            acc[:, y:y + tile, x:x + tile] += out[j] * taper
            wacc[y:y + tile, x:x + tile] += taper
    acc /= np.maximum(wacc, 1e-6)
    return acc[:2, :h, :w], acc[2, :h, :w]
