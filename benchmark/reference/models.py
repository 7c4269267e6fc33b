"""The configurations' generators, composed by name from an encoder piece
(``encoders/<encoder.kind>.py``) and a decoder piece
(``decoders/<decoder.kind>.py``): a new generator is new piece files, and
no edit here.

``param_shapes(cfg, img)`` names every tensor as the program's state dict
names it, so ``weights.seeded_tensors`` gives both sides the same values;
the benchmark holds the two name tables equal before a run. ``forward(cfg,
p, x)`` maps normalized NHWC images to NHWC marker maps in (-1, 1);
``quant="fp8"`` runs it in the control's precision (``layers.py``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .layers import rounder

PIECES = Path(__file__).resolve().parent
_loaded: Dict[Path, object] = {}


def _piece(folder: str, kind: str):
    path = PIECES / folder / f"{kind}.py"
    if path not in _loaded:
        if not path.exists():
            raise KeyError(f"no reference {folder[:-1]} {kind!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"benchmark.reference.{folder}.{kind.replace('-', '_').replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def encoder(cfg):
    return _piece("encoders", cfg["encoder"]["kind"])


def decoder(cfg):
    return _piece("decoders", cfg["decoder"]["kind"])


def param_shapes(cfg, img: int) -> Dict[str, Tuple[int, ...]]:
    """Every floating tensor of the configuration's generator at ``img`` px,
    by the program's name."""
    return decoder(cfg).shapes(cfg, img, encoder(cfg))


def forward(cfg, p: Dict[str, torch.Tensor], x, training: bool = False,
            quant: Optional[str] = None, checkpoint: bool = False):
    """Normalized NHWC ``x`` -> NHWC marker maps, in x's dtype."""
    return decoder(cfg).forward(cfg, encoder(cfg), p, x, training, rounder(quant), checkpoint)


def merged(cfg, p: Dict[str, torch.Tensor]):
    """The configuration and tensors as served (any LoRA folded in, in f32)."""
    return encoder(cfg).merged(cfg, p)


def seeded_params(cfg, img: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's seeded tensors as f32 (the served dtype's values)."""
    from .. import weights

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["serve_dtype"]]
    values = weights.seeded_dict(param_shapes(cfg, img), seed, device, dtype)
    return {n: t.float() for n, t in values.items()}
