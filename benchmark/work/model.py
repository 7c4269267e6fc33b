"""A whole step's model FLOPs from a configuration's shapes: the reference
generator run on the meta device under ``FlopCounterMode`` (matrix
products and convolutions; elementwise work is not counted). Training
counts the forward, the input gradients through every layer, frozen ones
too, and the weight gradients of the trainable tensors only, with no
recompute."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import models, train


def _meta_params(cfg, img: int, grads: bool):
    out = {}
    for n, shape in models.param_shapes(cfg, img).items():
        t = torch.empty(shape, device="meta")
        if grads and train.trainable(n) and "running_" not in n:
            t.requires_grad_(True)
        out[n] = t
    return out


def forward_flops(cfg, img: int, batch: int) -> float:
    """Model FLOPs of one serving forward of ``batch`` images (LoRA merged)."""
    scfg, p = models.merged(cfg, _meta_params(cfg, img, grads=False))
    x = torch.empty((batch, img, img, 3), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        models.forward(scfg, p, x)
    return float(fc.get_total_flops())


def train_flops(cfg, img: int, batch: int) -> float:
    """Model FLOPs of one training microbatch of ``batch`` images."""
    p = _meta_params(cfg, img, grads=True)
    x = torch.empty((batch, img, img, 3), device="meta")
    y = torch.empty((batch, img, img, cfg["markers"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        pred = models.forward(cfg, p, x, training=True)
        loss = ((pred - y) ** 2).mean()
        torch.autograd.grad(loss, [t for t in p.values() if t.requires_grad])
    return float(fc.get_total_flops())
