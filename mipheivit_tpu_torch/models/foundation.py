"""Foundation-encoder registry: ViTConfig presets for the pathology models.

Counterpart of ``mipheivit_tpu/models/foundation.py`` for its five ViT
encoders (all head dim 64, so every one runs on K1). The Swin and ResNet
encoders of the UNETR baseline are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .vit import ViTConfig


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    name: str
    family: str                     # "vit"
    vit_cfg: Optional[ViTConfig] = None
    hf_repo: Optional[str] = None   # provenance only; no net access assumed


_VIT_SPECS = {
    # timm vit_giant_patch14_reg4_dinov2: 40 x 1536, 24 heads, packed SwiGLU
    # (hidden 4096), layerscale 1e-5, cls + 4 reg tokens, no_embed_class
    "hoptimus0": (dict(
        patch_size=14, embed_dim=1536, depth=40, num_heads=24,
        mlp_hidden_dim=4096, mlp_type="swiglu", init_values=1e-5,
        reg_tokens=4, no_embed_class=True), "bioptimus/H-optimus-0"),
    # timm vit_giant_patch14_224 with overrides: depth 24, 8 reg tokens
    "univ2": (dict(
        patch_size=14, embed_dim=1536, depth=24, num_heads=24,
        mlp_hidden_dim=4096, mlp_type="swiglu", init_values=1e-5,
        reg_tokens=8, no_embed_class=True), "MahmoodLab/UNI2-h"),
    # timm vit_giant_patch14_dinov2 with patch 16, embed-class pos embed
    "provgigapath": (dict(
        patch_size=16, embed_dim=1536, depth=40, num_heads=24,
        mlp_hidden_dim=4096, mlp_type="swiglu", init_values=1e-5,
        reg_tokens=0, no_embed_class=False), "prov-gigapath/prov-gigapath"),
    # timm vit_large_patch14_dinov2 with patch 16: GELU MLP, layerscale
    "phikonv2": (dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_hidden_dim=4096, mlp_type="gelu", init_values=1e-5,
        reg_tokens=0, no_embed_class=False), "owkin/phikon-v2"),
    # timm vit_base_patch16_224: GELU, no layerscale, embed-class
    "sp85m": (dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12,
        mlp_hidden_dim=3072, mlp_type="gelu", init_values=None,
        reg_tokens=0, no_embed_class=False, norm_eps=1e-6),
        "MountSinaiCompPath/SP85M"),
}

NOT_PORTED = ("ctranspath", "restnet50_lunit_swav")
FOUNDATION_MODEL_NAMES = tuple(_VIT_SPECS) + NOT_PORTED


def get_encoder_spec(name: str, img_size) -> EncoderSpec:
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    if name in _VIT_SPECS:
        kw, repo = _VIT_SPECS[name]
        return EncoderSpec(name, "vit", ViTConfig(img_size=tuple(img_size), **kw), repo)
    if name in NOT_PORTED:
        raise NotImplementedError(f"encoder {name!r} is not ported to PyTorch yet")
    raise KeyError(f"Unknown encoder {name!r}; known: "
                   f"{', '.join(FOUNDATION_MODEL_NAMES)}")
