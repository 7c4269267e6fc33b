"""SMP-style multi-head U-Net on a ConvNeXt or ResNet-50 encoder (PyTorch).

Counterpart of ``mipheivit_tpu/models/smp_unet.py`` (reference:
src/generators/smp_unet.py): segmentation_models_pytorch's U-Net with the
reference's ``InterpDecoderBlock`` (nearest x2, concat, two conv-BN-ReLU),
decoder channels (256, 128, 64, 32, 16), one attention-gated head per
marker, and with ``foreground_head`` a shared-decoder head of one logit map
per marker (``UnetMultiHeadsFG``), which makes the forward return
``(masks, fg_logits)``.

Names follow the checkpoint layout the JAX package's ``smp_unet_from_torch``
(import_weights.py:661) reads: the FeatureListNet-flattened timm ConvNeXt
under ``encoder.model.`` (``stem.{0,1}``, ``stages_{s}.*``), smp's ResNet-50
under ``encoder.`` (torchvision names), ``decoder.blocks.{i}.conv{1,2}.{0,1}``,
``segmentation_head_{k}.{0,1}`` and ``foreground_head.1``. No kernel of the
port runs here: the convolutions are cuDNN's, as they are XLA in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .cnn import ConvNeXt, ResNet50
from .layers import BatchNorm2d, Conv2d, Dropout, pix2pix_init
from .mipheivit import SegmentationHead


class Conv2dReLU(nn.Sequential):
    """conv3x3 (no bias) + BN + ReLU (smp's ``Conv2dReLU``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
                         BatchNorm2d(out_channels), nn.ReLU())


class InterpDecoderBlock(nn.Module):
    """nearest x2 -> concat skip -> conv-BN-ReLU, dropout, conv-BN-ReLU
    (reference: smp_unet.py:13-50)."""

    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.0):
        super().__init__()
        self.conv1 = Conv2dReLU(in_channels, out_channels)
        self.drop = Dropout(dropout)
        self.conv2 = Conv2dReLU(out_channels, out_channels)

    def forward(self, x, skip=None):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.drop(self.conv1(x)))


class UnetMultiHeads(nn.Module):
    """Multi-head SMP U-Net. Input NHWC, output NHWC f32 masks, or
    ``(masks, fg_logits)`` with ``foreground_head``. ``encoder_dims`` /
    ``encoder_depths`` override the ConvNeXt's size (tests); computes in
    ``compute_dtype`` (None: the encoder's dtype)."""

    def __init__(self, encoder_name: str = "resnet50",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16), out_chans: int = 16,
                 dropout: float = 0.0, foreground_head: bool = False,
                 encoder_dims: Optional[Sequence[int]] = None,
                 encoder_depths: Optional[Sequence[int]] = None):
        super().__init__()
        self.out_chans = out_chans
        self.has_foreground_head = foreground_head
        self.compute_dtype: Optional[torch.dtype] = None
        if encoder_name.startswith("resnet"):
            self.encoder = ResNet50(num_stages=4)
        elif "convnext" in encoder_name:
            kw = {} if encoder_dims is None else {"dims": tuple(encoder_dims),
                                                  "depths": tuple(encoder_depths)}
            self.encoder = nn.Module()
            self.encoder.model = ConvNeXt(**kw)
        else:
            raise NotImplementedError(encoder_name)
        trunk = self.trunk
        # smp's decoder walk: the deepest map is the head, the shallower ones
        # are skips; blocks past the skip list upsample without one
        skips = trunk.channels[::-1]
        in_ch, skips = skips[0], skips[1:]
        blocks = []
        for i, out_ch in enumerate(decoder_channels):
            skip_ch = skips[i] if i < len(skips) else 0
            blocks.append(InterpDecoderBlock(in_ch + skip_ch, out_ch,
                                             dropout if i in (1, 2) else 0.0))
            in_ch = out_ch
        self.decoder = nn.Module()
        self.decoder.blocks = nn.ModuleList(blocks)
        for k in range(out_chans):
            self.add_module(f"segmentation_head_{k}", SegmentationHead(in_ch))
        if foreground_head:
            # one logit map per marker, no gate, no activation
            # (reference: smp_unet.py:368-377)
            self.foreground_head = SegmentationHead(in_ch, False, "none", out_chans)
        pix2pix_init(self.decoder)
        for name, m in self.named_children():
            if name.startswith("segmentation_head_") or name == "foreground_head":
                pix2pix_init(m)

    @property
    def trunk(self) -> nn.Module:
        """The encoder's feature extractor (smp's ResNet is the encoder
        itself, timm's ConvNeXt sits at ``encoder.model``)."""
        return self.encoder if isinstance(self.encoder, ResNet50) else self.encoder.model

    def forward(self, x):
        trunk = self.trunk
        first = trunk.conv1 if isinstance(trunk, ResNet50) else trunk.stem[0]
        x = x.to(self.compute_dtype or first.weight.dtype).permute(0, 3, 1, 2)
        skips = trunk(x)[::-1]
        h, skips = skips[0], skips[1:]
        for i, block in enumerate(self.decoder.blocks):
            h = block(h, skips[i] if i < len(skips) else None)
        masks = torch.cat([getattr(self, f"segmentation_head_{k}")(h)
                           for k in range(self.out_chans)], dim=1).permute(0, 2, 3, 1).float()
        if self.has_foreground_head:
            return masks, self.foreground_head(h).permute(0, 2, 3, 1).float()
        return masks


def build_smp_unet(model_name: str, img_size, nc_out: int, encoder_name: str = "resnet50",
                   dropout: float = 0.0, foreground_head: bool = False) -> UnetMultiHeads:
    """The JAX ``build_smp_unet``."""
    return UnetMultiHeads(encoder_name=encoder_name, out_chans=nc_out, dropout=dropout,
                          foreground_head=foreground_head)
