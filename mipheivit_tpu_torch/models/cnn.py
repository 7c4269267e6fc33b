"""CNN encoders (ResNet-50, ConvNeXt) and the ResNet-50 UNETR (PyTorch).

Counterpart of ``mipheivit_tpu/models/cnn.py``: timm's ``resnet50`` (the
lunit-SwAV weights of the UNETR baseline; reference:
src/generators/unet.py:95-113) and ``convnext_large`` (the SMP U-Net's
``tu-convnext_large``), NCHW, with module names in the timm / torchvision
layout: ``conv1``, ``bn1``, ``layer{1..4}.{b}.conv{1,2,3}`` /
``bn{1,2,3}`` / ``downsample.{0,1}``; ``stem.{0,1}``,
``stages_{s}.downsample.{0,1}``, ``stages_{s}.blocks.{b}.conv_dw`` /
``norm`` / ``mlp.fc{1,2}`` / ``gamma`` (smp's FeatureListNet flattens
``stages.{s}`` to ``stages_{s}``). Every BatchNorm is ``layers.BatchNorm2d``
(flax's arithmetic in training). The convolutions run on cuDNN: they are
XLA in the JAX package, with no Pallas kernel to port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d, LayerNorm, LayerNorm2d, Linear, pix2pix_init

RESNET50_PLAN = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))   # planes, blocks, stride


class Bottleneck(nn.Module):
    """torchvision / timm ResNet bottleneck (1x1 -> 3x3 -> 1x1, expansion 4)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = BatchNorm2d(4 * planes)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, 4 * planes, 1, stride, bias=False),
            BatchNorm2d(4 * planes)) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet50(nn.Module):
    """ResNet-50 trunk returning its stage features: the stem (64, stride
    2), then ``layer1`` .. ``layer{num_stages}`` (256 / 512 / 1024 / 2048
    channels at strides 4 / 8 / 16 / 32)."""

    def __init__(self, num_stages: int = 4):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for si, (planes, blocks, stride) in enumerate(RESNET50_PLAN[:num_stages]):
            layer = [Bottleneck(inplanes, planes, stride, downsample=True)]
            layer += [Bottleneck(4 * planes, planes) for _ in range(blocks - 1)]
            self.add_module(f"layer{si + 1}", nn.Sequential(*layer))
            inplanes = 4 * planes
        self.num_stages = num_stages
        self.channels = [64] + [4 * p for p, _, _ in RESNET50_PLAN[:num_stages]]

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        feats = [h]
        h = F.max_pool2d(h, 3, 2, 1)
        for si in range(self.num_stages):
            h = getattr(self, f"layer{si + 1}")(h)
            feats.append(h)
        return feats


class ConvNeXtBlock(nn.Module):
    """dw 7x7 conv -> channel LayerNorm (eps 1e-6) -> fc1 -> exact GELU ->
    fc2 -> layer scale ``gamma``, plus the residual; the MLP runs on NHWC."""

    def __init__(self, dim: int, ls_init: float = 1e-6):
        super().__init__()
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(dim, 4 * dim)
        self.mlp.fc2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(ls_init)))

    def forward(self, x):
        h = self.norm(self.conv_dw(x).permute(0, 2, 3, 1))
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(h))) * self.gamma.to(h.dtype)
        return x + h.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """ConvNeXt trunk returning its 4 stage features (strides 4 / 8 / 16 /
    32); convnext_large by default (dims 192 / 384 / 768 / 1536, depths 3 /
    3 / 27 / 3)."""

    def __init__(self, dims: Sequence[int] = (192, 384, 768, 1536),
                 depths: Sequence[int] = (3, 3, 27, 3)):
        super().__init__()
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, 4), LayerNorm2d(dims[0], eps=1e-6))
        for si, (dim, depth) in enumerate(zip(dims, depths)):
            stage = nn.Module()
            stage.downsample = nn.Identity() if si == 0 else nn.Sequential(
                LayerNorm2d(dims[si - 1], eps=1e-6), Conv2d(dims[si - 1], dim, 2, 2))
            stage.blocks = nn.Sequential(*(ConvNeXtBlock(dim) for _ in range(depth)))
            self.add_module(f"stages_{si}", stage)
        self.n_stages = len(dims)
        self.channels = list(dims)

    def forward(self, x) -> List[torch.Tensor]:
        h = self.stem(x)
        feats = []
        for si in range(self.n_stages):
            stage = getattr(self, f"stages_{si}")
            h = stage.blocks(stage.downsample(h))
            feats.append(h)
        return feats


class UnetResnet50(nn.Module):
    """UNETR with the lunit-SwAV ResNet-50 encoder (reference:
    unet.py:95-113; the JAX ``UnetResnet50``): an RGB conv-stem skip and the
    stem, layer1, layer2 and layer3 taps (64 / 64 / 256 / 512 / 1024
    channels) -> the CellViT decoder -> one attention-gated tanh head per
    marker. Input NHWC, output NHWC f32.

    Names: ``encoder.model.*`` (timm resnet50 without ``layer4``),
    ``encoder.convsteam.{0,1}.block.{0,1}``, ``decoder.*`` and
    ``segmentation_head_{k}`` as in ``unetr.UnetrViT``. Neither package
    imports a reference checkpoint of this model (the JAX ``load_generator``
    raises for it)."""

    # this model's top-level scopes under their JAX module names
    # (``train.optim.jax_path``)
    JAX_SCOPES = {"encoder.model.": "model.", "encoder.convsteam.": "convsteam_"}

    def __init__(self, out_chans: int = 16, drop_rate: float = 0.0):
        from .mipheivit import SegmentationHead
        from .unetr import DECODER_OUT_CHANNELS, CellViTDecoder, Conv2DBlock

        super().__init__()
        self.out_chans = out_chans
        self.compute_dtype: Optional[torch.dtype] = None
        self.encoder = nn.Module()
        self.encoder.convsteam = nn.Sequential(Conv2DBlock(3, 32, 3, drop_rate),
                                               Conv2DBlock(32, 64, 3, drop_rate))
        self.encoder.model = ResNet50(num_stages=3)
        self.decoder = CellViTDecoder((64, 64, 256, 512, 1024), drop_rate)
        for k in range(out_chans):
            self.add_module(f"segmentation_head_{k}", SegmentationHead(DECODER_OUT_CHANNELS))
        pix2pix_init(self.encoder.convsteam)
        pix2pix_init(self.decoder)
        for k in range(out_chans):
            pix2pix_init(getattr(self, f"segmentation_head_{k}"))

    def forward(self, x):
        dtype = self.compute_dtype or self.encoder.model.conv1.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2)
        stem = self.encoder.convsteam(x)
        h = self.decoder([stem] + self.encoder.model(x))
        out = torch.cat([getattr(self, f"segmentation_head_{k}")(h)
                         for k in range(self.out_chans)], dim=1)
        return out.permute(0, 2, 3, 1).float()
