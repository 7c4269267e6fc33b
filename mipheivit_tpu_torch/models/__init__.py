"""Model zoo + generator factory (reference: src/generators/__init__.py:9-56)."""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from .foundation import FOUNDATION_MODEL_NAMES, get_encoder_spec
from .mipheivit import MipheiViT, check_input_size
from .vit import ViTConfig, VisionTransformer


def get_generator(model_name: str, img_size, nc_out: int,
                  encoder_name: str = "hoptimus0", dtype=torch.float32,
                  device=None, dropout: float = 0.0,
                  foreground_head: bool = False) -> nn.Module:
    """Build a generator with freshly initialised weights on ``device``: the
    card by default (raises without one), the CPU with ``device="cpu"``;
    returned in eval mode with its floating parameters in ``dtype``.

    Dispatched as the JAX ``get_generator`` (mipheivit_tpu/models/__init__.py:21-61):
    ``myvitmatte`` (always LoRA rank 8, alpha 1.0; reference:
    mipheivit.py:224-233), then ``smp_unet``, then ``unet*`` (``unet_lora``
    with LoRA rank 8, on a ViT, ctranspath's Swin or ResNet-50), then
    ``hemit`` (``hemit.build_hemit``, the dual-branch generator). ``dropout``
    is the config's ``model.dropout`` and ``foreground_head`` its
    ``train.foreground_head`` (read by the SMP U-Net only), as the JAX
    builders read them."""
    device = resolve_device(device)
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    with torch.device(device):
        if model_name.startswith("myvitmatte"):
            spec = get_encoder_spec(encoder_name, img_size)
            if spec.family != "vit":
                raise ValueError("myvitmatte requires a ViT encoder")
            check_input_size(img_size)
            model = MipheiViT(spec.vit_cfg.replace(lora_rank=8, lora_alpha=1.0), out_chans=nc_out)
        elif model_name.startswith("smp_unet"):
            from .smp_unet import build_smp_unet

            model = build_smp_unet(model_name, img_size, nc_out, encoder_name, dropout,
                                   foreground_head)
        elif model_name.startswith("unet"):
            from .unetr import build_unetr

            model = build_unetr(model_name, img_size, nc_out, encoder_name, dropout)
        elif model_name.startswith("hemit"):
            from .hemit import build_hemit

            model = build_hemit(img_size, 3, nc_out)
        else:
            raise NotImplementedError(f"Unknown model_name {model_name!r}")
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
