"""Seeded weights by name, made on the device in two large draws.

The rules are ``chip_smoke.py::seeded_fill``'s (a copy: the yardstick does
not import the program's smoke): BatchNorm running variances U[0.5, 1.5),
running means N(0, 0.1), layer scales U[0.05, 0.15), other 1-D ``.weight``
tensors (norm scales) U[0.9, 1.1), everything else N(0, 0.02), LoRA B
non-zero. Every tensor of the state dict takes its values, in sorted name
order, from one normal and one uniform draw of one ``torch.Generator`` on
the device, in the served dtype; so the program and the reference, which
name their tensors alike, get the same values from the same seed.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

_HEAD_CONV = re.compile(r"segmentation_head_\d+\.1\.weight")


def rule(name: str, ndim: int) -> Tuple[str, float, float]:
    """(draw, scale, offset) of one tensor: ``value = draw * scale + offset``."""
    if "running_var" in name:
        return "uniform", 1.0, 0.5
    if "running_mean" in name:
        return "normal", 0.1, 0.0
    if name.endswith("gamma"):
        return "uniform", 0.1, 0.05
    if ndim == 1 and name.endswith(".weight"):
        return "uniform", 0.2, 0.9
    return "normal", 0.02, 0.0


def seed_key(seed: int) -> int:
    """A generator seed from any whole number (the driver's exceed 32 bits)."""
    return int(seed) % (2 ** 63 - 1)


def seeded_tensors(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                   dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Values for every ``name -> shape``: ``dtype``-valued tensors on ``device``
    (running statistics in f32, from the same ``dtype`` draws)."""
    names = sorted(shapes)
    rules = {n: rule(n, len(shapes[n])) for n in names}
    sizes = {n: int(torch.Size(shapes[n]).numel()) for n in names}
    total = {"normal": 0, "uniform": 0}
    for n in names:
        total[rules[n][0]] += sizes[n]
    g = torch.Generator(device=device).manual_seed(seed_key(seed))
    draws = {"normal": torch.randn(total["normal"], generator=g, device=device, dtype=dtype),
             "uniform": torch.rand(total["uniform"], generator=g, device=device, dtype=dtype)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for n in names:
        kind, scale, offset = rules[n]
        chunk = draws[kind][at[kind]:at[kind] + sizes[n]].float() * scale + offset
        at[kind] += sizes[n]
        if "running_" not in n:
            chunk = chunk.to(dtype)
        out[n] = chunk.view(shapes[n])
    return out


def contrast_head(w: torch.Tensor) -> torch.Tensor:
    """A marker head's final 3x3 conv ``[1, C, 3, 3]`` made to respond to
    contrast: zero sum over its fan-in, times 25 (``chip_smoke.py``'s
    ``contrast_head``: with N(0, 0.02) weights the UNETR's maps sit near a
    constant, a few bf16 steps wide, so its output would test rounding
    alone)."""
    wf = w.float()
    return (wf - wf.mean(dim=(1, 2, 3), keepdim=True)) * 25.0


def seeded_dict(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``seeded_tensors`` with each per-marker head's final conv through
    ``contrast_head``."""
    values = seeded_tensors(shapes, seed, device, dtype)
    for n in values:
        if _HEAD_CONV.fullmatch(n.split("decoder.", 1)[-1]):
            values[n] = contrast_head(values[n]).to(dtype)
    return values


def fill(model: torch.nn.Module, seed: int, dtype=torch.bfloat16) -> torch.nn.Module:
    """Every floating tensor of ``model``'s state dict from ``seeded_dict``,
    copied into the module's own dtype."""
    state = {n: t for n, t in model.state_dict().items() if t.is_floating_point()}
    device = next(iter(state.values())).device
    values = seeded_dict({n: tuple(t.shape) for n, t in state.items()}, seed, device, dtype)
    with torch.no_grad():
        for n, t in state.items():
            t.copy_(values.pop(n))
    return model
