"""UNETR-style U-Net on a foundation-ViT pyramid (PyTorch).

Counterpart of ``mipheivit_tpu/models/unetr.py`` (reference:
src/generators/unet.py): the ViT's un-normed tokens after 4 blocks
(``extract_layers_for_depth``), re-gridded to the /16 grid by nearest
neighbour when the patch is not 16, go through deconvolution pyramids
beside an RGB conv-stem skip (``ViTFeatureUpsampler``), then a CellViT
decoder of transposed convolutions, then one attention-gated head per
marker. ``unet_lora`` carries LoRA rank 8 on the ViT (``build_unetr``).

Module names are the reference checkpoint's, which the JAX package's
``unetr_from_torch`` (import_weights.py:389-466) reads: ``encoder.model.*``
(the timm ViT), ``encoder.feature_upsampler.convsteam.{i}.block.{0,1}``,
``encoder.feature_upsampler.upsampler{j}.{d+1}.block.{0,1,2}`` (slot 0 is
the parameter-free re-grid), ``decoder.bottleneck_upsampler``,
``decoder.decoder{3,2,1}_upsampler.{b}``, ``decoder.decoder0_header.{0,1,2}``
and ``segmentation_head_{k}.{0,1}``; a reference checkpoint loads with
``load_state_dict``.

The encoder blocks run K1 and K2 on the card, as the flagship's do; the
convolutions run on cuDNN (XLA in the JAX package). NCHW inside, NHWC at
the call.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .foundation import get_encoder_spec
from .layers import BatchNorm2d, Conv2d, ConvTranspose2d, Dropout, pix2pix_init
from .mipheivit import SegmentationHead
from .vit import ViTConfig, VisionTransformer

# the CellViT decoder's output width, which every marker head reads
# (reference: unet.py, ``decoder_out_channels``)
DECODER_OUT_CHANNELS = 32


class Conv2DBlock(nn.Module):
    """conv k x k + BN + ReLU + dropout (reference: unet.py:441-474)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.block = nn.Sequential(Conv2d(in_channels, out_channels, kernel_size, padding=pad),
                                   BatchNorm2d(out_channels), nn.ReLU(), Dropout(dropout))

    def forward(self, x):
        return self.block(x)


class Deconv2DBlock(nn.Module):
    """ConvTranspose(k2, s2) + conv k x k + BN + ReLU + dropout
    (reference: unet.py:477-519)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.block = nn.Sequential(
            ConvTranspose2d(in_channels, out_channels, 2, stride=2),
            Conv2d(out_channels, out_channels, kernel_size, padding=pad),
            BatchNorm2d(out_channels), nn.ReLU(), Dropout(dropout))

    def forward(self, x):
        return self.block(x)


def _nearest_regrid(x, target_hw: Tuple[int, int]):
    """``F.interpolate(mode="nearest")`` onto ``target_hw`` (source index
    ``floor(i * in / out)``), the patch-14 -> /16 re-grid (reference:
    unet.py:196-213); NCHW."""
    (in_h, in_w), (out_h, out_w) = x.shape[-2:], target_hw
    idx_h = np.minimum(np.floor(np.arange(out_h) * in_h / out_h), in_h - 1).astype(np.int64)
    idx_w = np.minimum(np.floor(np.arange(out_w) * in_w / out_w), in_w - 1).astype(np.int64)
    idx_h = torch.from_numpy(idx_h).to(x.device)
    idx_w = torch.from_numpy(idx_w).to(x.device)
    return x.index_select(2, idx_h).index_select(3, idx_w)


class ViTFeatureUpsampler(nn.Module):
    """Deconvolution pyramids over the 4 ViT taps plus the RGB conv-stem
    skip (reference: unet.py:176-235). Returns the 5 decoder inputs at
    strides 1, 2, 4, 8, 16."""

    def __init__(self, embed_dim: int, drop_rate: float = 0.0):
        super().__init__()
        if embed_dim < 512:
            skip11, skip12, bottleneck = 256, 128, 312
        else:
            skip11, skip12, bottleneck = 512, 256, 512
        self.convsteam = nn.Sequential(Conv2DBlock(3, 32, 3, drop_rate),
                                       Conv2DBlock(32, 64, 3, drop_rate))
        self.upsampler0 = nn.Sequential(
            nn.Identity(), Deconv2DBlock(embed_dim, skip11, 3, drop_rate),
            Deconv2DBlock(skip11, skip12, 3, drop_rate), Deconv2DBlock(skip12, 128, 3, drop_rate))
        self.upsampler1 = nn.Sequential(
            nn.Identity(), Deconv2DBlock(embed_dim, skip11, 3, drop_rate),
            Deconv2DBlock(skip11, 256, 3, drop_rate))
        self.upsampler2 = nn.Sequential(
            nn.Identity(), Deconv2DBlock(embed_dim, bottleneck, 3, drop_rate))
        self.channels = (64, 128, 256, bottleneck, embed_dim)

    def forward(self, x_rgb, features: Sequence[torch.Tensor],
                target_grid: Optional[Tuple[int, int]] = None):
        stem = self.convsteam(x_rgb)
        feats = list(features)
        if target_grid is not None:
            feats = [_nearest_regrid(f, target_grid) for f in feats]
        return [stem, self.upsampler0(feats[0]), self.upsampler1(feats[1]),
                self.upsampler2(feats[2]), feats[3]]


class CellViTDecoder(nn.Module):
    """U-Net decoder with transposed-convolution stages (reference:
    unet.py:288-404); the channel plan comes from ``encoder_out_channels``
    [c0 .. c4], the output has ``DECODER_OUT_CHANNELS``."""

    def __init__(self, encoder_out_channels: Sequence[int], drop_rate: float = 0.0):
        super().__init__()
        c0, c1, c2, c3, c4 = encoder_out_channels

        def blocks(c, n):
            return [Conv2DBlock(2 * c, c, 3, drop_rate)] + [
                Conv2DBlock(c, c, 3, drop_rate) for _ in range(n - 1)]

        self.bottleneck_upsampler = ConvTranspose2d(c4, c3, 2, stride=2)
        self.decoder3_upsampler = nn.Sequential(*blocks(c3, 3), ConvTranspose2d(c3, c2, 2, stride=2))
        self.decoder2_upsampler = nn.Sequential(*blocks(c2, 2), ConvTranspose2d(c2, c1, 2, stride=2))
        self.decoder1_upsampler = nn.Sequential(*blocks(c1, 2), ConvTranspose2d(c1, c0, 2, stride=2))
        self.decoder0_header = nn.Sequential(*blocks(c0, 2), Conv2d(c0, DECODER_OUT_CHANNELS, 1))

    def forward(self, features):
        z0, z1, z2, z3, z4 = features
        h = self.decoder3_upsampler(torch.cat([z3, self.bottleneck_upsampler(z4)], dim=1))
        h = self.decoder2_upsampler(torch.cat([z2, h], dim=1))
        h = self.decoder1_upsampler(torch.cat([z1, h], dim=1))
        return self.decoder0_header(torch.cat([z0, h], dim=1))


def extract_layers_for_depth(depth: int) -> Tuple[int, ...]:
    """The 4 tapped blocks (reference: unet.py:132-138)."""
    if depth == 4:
        return (0, 1, 2, 3)
    if depth > 4:
        return tuple(int(v) for v in np.round(np.linspace(depth // 4, depth - 1, 4)))
    raise ValueError("ViT should have a depth higher than 3")


class UnetrViT(nn.Module):
    """The UNETR generator on a ViT encoder. Input NHWC ``[B, H, W, 3]``,
    output NHWC f32 ``[B, H, W, C]``. Computes in the ViT's
    ``compute_dtype`` (None: the patch embedding's dtype)."""

    # this model's top-level scopes under their JAX module names
    # (``train.optim.jax_path``)
    JAX_SCOPES = {"encoder.model.": "encoder_vit.",
                  "encoder.feature_upsampler.": "feature_upsampler."}

    def __init__(self, vit_cfg: ViTConfig, out_chans: int = 16, drop_rate: float = 0.0):
        super().__init__()
        self.out_chans = out_chans
        emb = vit_cfg.embed_dim
        self.encoder = nn.Module()
        self.encoder.model = VisionTransformer(vit_cfg)
        self.encoder.feature_upsampler = ViTFeatureUpsampler(emb, drop_rate)
        self.decoder = CellViTDecoder(self.encoder.feature_upsampler.channels, drop_rate)
        for k in range(out_chans):
            self.add_module(f"segmentation_head_{k}", SegmentationHead(DECODER_OUT_CHANNELS))
        for m in [self.encoder.feature_upsampler, self.decoder] + [
                getattr(self, f"segmentation_head_{k}") for k in range(out_chans)]:
            pix2pix_init(m)

    @property
    def vit_cfg(self) -> ViTConfig:
        return self.encoder.model.cfg

    def forward(self, x):
        vit = self.encoder.model
        cfg = vit.cfg
        dtype = vit.compute_dtype or vit.patch_embed.proj.weight.dtype
        x = x.to(dtype)
        _, inter = vit(x, intermediates=extract_layers_for_depth(cfg.depth))
        b, (gh, gw) = x.shape[0], cfg.grid_size
        feats = [t[:, cfg.num_prefix_tokens:].transpose(1, 2).reshape(b, cfg.embed_dim, gh, gw)
                 for t in inter]
        target = None if cfg.patch_size == 16 else (x.shape[1] // 16, x.shape[2] // 16)
        feats = self.encoder.feature_upsampler(x.permute(0, 3, 1, 2), feats, target)
        h = self.decoder(feats)
        out = torch.cat([getattr(self, f"segmentation_head_{k}")(h)
                         for k in range(self.out_chans)], dim=1)
        return out.permute(0, 2, 3, 1).float()


def build_unetr(model_name: str, img_size, nc_out: int, encoder_name: str = "hoptimus0",
                dropout: float = 0.0) -> nn.Module:
    """The JAX ``build_unetr``: a ViT encoder gives ``UnetrViT`` (LoRA rank
    8, alpha 1 when ``"lora"`` is in the name), ``restnet50_lunit_swav``
    gives ``UnetResnet50``; the Swin encoder (ctranspath) is not ported."""
    spec = get_encoder_spec(encoder_name, img_size)
    if spec.family == "vit":
        use_lora = "lora" in model_name
        vit_cfg = spec.vit_cfg.replace(lora_rank=8 if use_lora else 0, lora_alpha=1.0)
        return UnetrViT(vit_cfg, out_chans=nc_out, drop_rate=dropout)
    if spec.family == "resnet":
        from .cnn import UnetResnet50

        return UnetResnet50(out_chans=nc_out, drop_rate=dropout)
    raise NotImplementedError(
        f"unetr encoder family {spec.family!r} ({encoder_name}) is not ported to PyTorch yet")
