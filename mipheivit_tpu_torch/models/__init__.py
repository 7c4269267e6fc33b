"""Model zoo + generator factory (reference: src/generators/__init__.py:9-56)."""

from __future__ import annotations

import torch

from .._device import resolve_device
from .foundation import FOUNDATION_MODEL_NAMES, get_encoder_spec
from .mipheivit import MipheiViT, check_input_size
from .vit import ViTConfig, VisionTransformer


def get_generator(model_name: str, img_size, nc_out: int,
                  encoder_name: str = "hoptimus0", dtype=torch.float32,
                  device=None) -> MipheiViT:
    """Build a generator with freshly initialised weights on ``device``: the
    card by default (raises without one), the CPU with ``device="cpu"``.

    Only the flagship ``myvitmatte`` family is ported. It always carries
    LoRA rank 8, alpha 1.0 (reference: mipheivit.py:224-233)."""
    device = resolve_device(device)
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    if not model_name.startswith("myvitmatte"):
        raise NotImplementedError(f"generator {model_name!r} is not ported to PyTorch yet")
    spec = get_encoder_spec(encoder_name, img_size)
    check_input_size(img_size)
    vit_cfg = spec.vit_cfg.replace(lora_rank=8, lora_alpha=1.0)
    with torch.device(device):
        model = MipheiViT(vit_cfg, out_chans=nc_out)
    from ..infer.loading import cast_params

    return cast_params(model.eval(), dtype)


__all__ = [
    "ViTConfig",
    "VisionTransformer",
    "MipheiViT",
    "check_input_size",
    "get_generator",
    "get_encoder_spec",
    "FOUNDATION_MODEL_NAMES",
]
