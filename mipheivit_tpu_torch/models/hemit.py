"""HEMIT baseline zoo (PyTorch): the paper's dual-branch
``ResnetGeneratorSwinT``, the pix2pix generators and discriminators.

Counterpart of ``mipheivit_tpu/models/hemit.py`` (reference:
src/generators/hemit_models.py). ``ResnetGeneratorSwinT`` is a pix2pix
ResNet generator (c7s1, three stride-2 convs, ResNet blocks, three
transposed convs over skip concats, c7s1 + tanh) beside a timm Swin-tiny
whose post-downsample taps fuse into the three skips through
``GatedCrossAttention``: a sigmoid gate picks the top-k CNN positions,
multi-head attention of those positions' CNN features over the (upsampled)
Swin features at the same positions, results scattered back.

Module and parameter names are the HEMIT codebase's for
``ResnetGeneratorSwinT`` (``initial_layers.{1,2}``,
``downsampling_layers.{i}.{0,1}``, ``resnet_blocks.{i}.conv_block.{1,2,5,6}``,
``swinT.*``, ``cross_atts.{i}.{swinT_transform, attention.in_proj_*,
attention.out_proj, gate.0, upsample_blocks.{j}.{0,2}}``,
``upsampling_layers.{i}.{0,1}``, ``final_layers.1``; ``models.import_hemit``
loads such a checkpoint), pix2pix's ``model.{i}`` for ``ResnetGenerator``,
``NLayerDiscriminator`` and ``PixelDiscriminator`` (``net.{i}``), and the
JAX module names for ``UnetGenerator`` (pix2pix nests it recursively; no
importer reads it in either package).

Positions are flattened row-major over (H, W), as JAX flattens NHWC, so the
top-k indices name the same pixels. The attention is plain PyTorch (f32
logits, softmax; no kernel of the port computes a gathered top-k set); the
convolutions run on cuDNN. Public forwards take NHWC and return NHWC f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchNorm2d, Conv2d, ConvTranspose2d, InstanceNorm2d, Linear)
from .swin import SwinConfig, SwinTransformer, softmax_attention


def hemit_norm(kind: str, chans: int) -> nn.Module:
    """The JAX ``_Norm``: ``"batch"`` (flax arithmetic), ``"instance"`` (no
    affine, biased variance, eps 1e-5) or anything else for none."""
    if kind == "batch":
        return BatchNorm2d(chans)
    if kind == "instance":
        return InstanceNorm2d()
    return nn.Identity()


class HemitResnetBlock(nn.Module):
    """``x + [pad, conv3, norm, ReLU, pad, conv3, norm](x)`` with reflect
    padding (pix2pix ``ResnetBlock``)."""

    def __init__(self, dim: int, norm: str = "batch"):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), Conv2d(dim, dim, 3), hemit_norm(norm, dim), nn.ReLU(),
            nn.ReflectionPad2d(1), Conv2d(dim, dim, 3), hemit_norm(norm, dim))

    def forward(self, x):
        return x + self.conv_block(x)


class PackedMultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight`` ``[3C, C]``,
    ``in_proj_bias``, ``out_proj``) and function, batch first, the logits
    in f32."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, kv):
        b, n, c = q.shape
        w, bias = self.in_proj_weight.to(q.dtype), self.in_proj_bias.to(q.dtype)
        qp = F.linear(q, w[:c], bias[:c])
        kp = F.linear(kv, w[c:2 * c], bias[c:2 * c])
        vp = F.linear(kv, w[2 * c:], bias[2 * c:])
        hd = c // self.num_heads
        qp, kp, vp = (t.reshape(b, -1, self.num_heads, hd).transpose(1, 2) for t in (qp, kp, vp))
        out = softmax_attention(qp, kp, vp).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class GatedCrossAttention(nn.Module):
    """Top-k gated cross-attention fusion (reference: hemit_models.py:1225-1298).

    The Swin tap goes through a 1x1 conv to the CNN width and
    ``upsample_factor`` blocks of (transposed conv k4 s2 p1, ReLU, conv3) to
    the CNN map's grid; ``sigmoid(gate(cnn))`` ranks the positions; the
    ``min(k, H*W)`` best attend (queries: their CNN features; keys and
    values: the Swin features there) and replace their CNN features. NCHW
    in and out. ``last_indices`` keeps the last forward's top-k indices
    ``[B, k]`` (the order ``torch.topk`` gives)."""

    def __init__(self, cnn_channels: int, swin_channels: int, num_heads: int = 8, k: int = 1000,
                 upsample_factor: int = 2):
        super().__init__()
        c = cnn_channels
        self.k = k
        self.swinT_transform = Conv2d(swin_channels, c, 1)
        self.upsample_blocks = nn.ModuleList(
            nn.Sequential(ConvTranspose2d(c, c, 4, 2, 1), nn.ReLU(), Conv2d(c, c, 3, padding=1))
            for _ in range(upsample_factor))
        self.gate = nn.Sequential(Conv2d(c, 1, 1), nn.Sigmoid())
        self.attention = PackedMultiheadAttention(c, num_heads)
        self.last_indices: Optional[torch.Tensor] = None

    def forward(self, cnn_feat, swin_feat):
        s = self.swinT_transform(swin_feat)
        for blk in self.upsample_blocks:
            s = blk(s)
        b, c, h, w = cnn_feat.shape
        n = h * w
        k = min(self.k, n)
        flat_cnn = cnn_feat.permute(0, 2, 3, 1).reshape(b, n, c)
        flat_swin = s.permute(0, 2, 3, 1).reshape(b, n, c)
        _, idx = torch.topk(self.gate(cnn_feat).reshape(b, n), k, dim=1)
        self.last_indices = idx.detach()
        gather = idx[..., None].expand(-1, -1, c)
        out = self.attention(torch.gather(flat_cnn, 1, gather), torch.gather(flat_swin, 1, gather))
        attended = flat_cnn.scatter(1, gather, out.to(flat_cnn.dtype))
        return attended.reshape(b, h, w, c).permute(0, 3, 1, 2)


class ResnetGeneratorSwinT(nn.Module):
    """The HEMIT dual-branch generator (reference: hemit_models.py:1058-1222).

    Input NHWC ``[B, H, W, 3]`` cast to ``compute_dtype`` (None: the
    parameters' dtype), output NHWC f32 tanh maps. The Swin branch is built
    for ``img_size`` (its window tables); its taps after the downsamples of
    stages 1-3 (strides 8, 16, 32) are brought up ``log2(patch)`` times to
    the CNN skips' strides 2, 4, 8."""

    def __init__(self, out_channels: int, img_size, ngf: int = 64, n_blocks: int = 6,
                 norm: str = "batch", swin_cfg: Optional[SwinConfig] = None, top_k: int = 1000,
                 in_channels: int = 3):
        super().__init__()
        if isinstance(img_size, int):
            img_size = (img_size, img_size)
        self.compute_dtype: Optional[torch.dtype] = None
        self.n_blocks = n_blocks
        self.initial_layers = nn.Sequential(nn.ReflectionPad2d(3), Conv2d(in_channels, ngf, 7),
                                            hemit_norm(norm, ngf), nn.ReLU())
        self.downsampling_layers = nn.ModuleList(
            nn.Sequential(Conv2d(ngf * m, ngf * m * 2, 3, 2, 1), hemit_norm(norm, ngf * m * 2),
                          nn.ReLU())
            for m in (1, 2, 4))
        self.resnet_blocks = nn.ModuleList(HemitResnetBlock(ngf * 8, norm)
                                           for _ in range(n_blocks))
        swin_cfg = swin_cfg or SwinConfig(img_size=tuple(img_size))
        self.swinT = SwinTransformer(swin_cfg)
        n_up = int(np.log2(swin_cfg.patch_size))
        self.cross_atts = nn.ModuleList(
            GatedCrossAttention(ngf * 2 ** (i + 1), swin_cfg.stage_dim(i + 1), k=top_k,
                                upsample_factor=n_up)
            for i in range(3))
        self.upsampling_layers = nn.ModuleList(
            nn.Sequential(ConvTranspose2d(ngf * m * 2, ngf * m // 2, 3, 2, 1, output_padding=1),
                          hemit_norm(norm, ngf * m // 2), nn.ReLU())
            for m in (8, 4, 2))
        self.final_layers = nn.Sequential(nn.ReflectionPad2d(3), Conv2d(ngf, out_channels, 7),
                                          nn.Tanh())

    @property
    def swin_cfg(self) -> SwinConfig:
        return self.swinT.cfg

    def forward(self, x):
        dtype = self.compute_dtype or self.final_layers[1].weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2)
        h = self.initial_layers(x)
        downs = []
        for layer in self.downsampling_layers:
            h = layer(h)
            downs.append(h)
        for blk in self.resnet_blocks:
            h = blk(h)
        _, taps = self.swinT(x, collect="post_downsample")
        downs = [att(d, t.permute(0, 3, 1, 2)) for att, d, t in zip(self.cross_atts, downs, taps)]
        for layer, feat in zip(self.upsampling_layers, reversed(downs)):
            h = layer(torch.cat([h, feat], dim=1))
        return self.final_layers(h).permute(0, 2, 3, 1).float()


class ResnetGenerator(nn.Module):
    """The plain pix2pix ResNet generator (two stride-2 convs, ``n_blocks``
    ResNet blocks, two transposed convs), in pix2pix's ``model.{i}``
    layout."""

    def __init__(self, out_channels: int, ngf: int = 64, n_blocks: int = 9,
                 norm: str = "instance", in_channels: int = 3):
        super().__init__()
        self.compute_dtype: Optional[torch.dtype] = None
        layers = [nn.ReflectionPad2d(3), Conv2d(in_channels, ngf, 7), hemit_norm(norm, ngf),
                  nn.ReLU()]
        for m in (1, 2):
            layers += [Conv2d(ngf * m, ngf * m * 2, 3, 2, 1), hemit_norm(norm, ngf * m * 2),
                       nn.ReLU()]
        layers += [HemitResnetBlock(ngf * 4, norm) for _ in range(n_blocks)]
        for m in (4, 2):
            layers += [ConvTranspose2d(ngf * m, ngf * m // 2, 3, 2, 1, output_padding=1),
                       hemit_norm(norm, ngf * m // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), Conv2d(ngf, out_channels, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        dtype = self.compute_dtype or self.model[1].weight.dtype
        return self.model(x.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()


class UnetGenerator(nn.Module):
    """The pix2pix U-Net generator: ``num_downs`` stride-2 4x4 convs (norm
    on all but the outer and innermost, LeakyReLU 0.2), transposed convs
    back over the skips (ReLU, norm), tanh. JAX names: ``down{i}``,
    ``down{i}_norm``, ``up{i}``, ``up{i}_norm``, ``up_final``."""

    def __init__(self, out_channels: int, num_downs: int = 7, ngf: int = 64,
                 norm: str = "batch", in_channels: int = 3):
        super().__init__()
        self.compute_dtype: Optional[torch.dtype] = None
        self.num_downs = num_downs
        self.chans = [min(ngf * 2 ** i, ngf * 8) for i in range(num_downs)]
        prev = in_channels
        for i, c in enumerate(self.chans):
            self.add_module(f"down{i}", Conv2d(prev, c, 4, 2, 1))
            if 0 < i < num_downs - 1:
                self.add_module(f"down{i}_norm", hemit_norm(norm, c))
            prev = c
        for i, c in enumerate(reversed(self.chans[:-1])):
            self.add_module(f"up{i}", ConvTranspose2d(prev, c, 4, 2, 1))
            self.add_module(f"up{i}_norm", hemit_norm(norm, c))
            prev = 2 * c
        self.up_final = ConvTranspose2d(prev, out_channels, 4, 2, 1)

    def forward(self, x):
        n = self.num_downs
        h = x.to(self.compute_dtype or self.up_final.weight.dtype).permute(0, 3, 1, 2)
        skips = []
        for i in range(n):
            h = getattr(self, f"down{i}")(h)
            if 0 < i < n - 1:
                h = getattr(self, f"down{i}_norm")(h)
            skips.append(h)
            h = F.leaky_relu(h, 0.2)
        for i in range(n - 1):
            h = getattr(self, f"up{i}_norm")(getattr(self, f"up{i}")(F.relu(h)))
            h = torch.cat([h, skips[n - 2 - i]], dim=1)
        return torch.tanh(self.up_final(F.relu(h))).permute(0, 2, 3, 1).float()


class NLayerDiscriminator(nn.Module):
    """pix2pix 70x70 PatchGAN without spectral norm, ``model.{i}``: NHWC
    ``[B, H, W, in_channels]`` -> NHWC logits."""

    def __init__(self, in_channels: int = 6, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance"):
        super().__init__()
        layers = [Conv2d(in_channels, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        prev = ndf
        for i in range(1, n_layers):
            nf = ndf * min(2 ** i, 8)
            layers += [Conv2d(prev, nf, 4, 2, 1, bias=False), hemit_norm(norm, nf),
                       nn.LeakyReLU(0.2)]
            prev = nf
        nf = ndf * min(2 ** n_layers, 8)
        layers += [Conv2d(prev, nf, 4, 1, 1, bias=False), hemit_norm(norm, nf), nn.LeakyReLU(0.2),
                   Conv2d(nf, 1, 4, 1, 1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        dtype = self.model[0].weight.dtype
        return self.model(x.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PixelDiscriminator(nn.Module):
    """pix2pix 1x1 PatchGAN, ``net.{i}``: NHWC in, NHWC logits."""

    def __init__(self, in_channels: int = 6, ndf: int = 64, norm: str = "instance"):
        super().__init__()
        self.net = nn.Sequential(Conv2d(in_channels, ndf, 1), nn.LeakyReLU(0.2),
                                 Conv2d(ndf, 2 * ndf, 1, bias=False), hemit_norm(norm, 2 * ndf),
                                 nn.LeakyReLU(0.2), Conv2d(2 * ndf, 1, 1))

    def forward(self, x):
        dtype = self.net[0].weight.dtype
        return self.net(x.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def build_hemit(img_size, nc_in: int = 3, nc_out: int = 3) -> ResnetGeneratorSwinT:
    """The reference ``get_generator_hemit(netG="SwinTResnet")``: ngf 64, 6
    blocks, batch norm, Swin-tiny (patch 4, window 7) built for
    ``img_size``."""
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    return ResnetGeneratorSwinT(out_channels=nc_out, img_size=img_size, ngf=64, n_blocks=6,
                                norm="batch", in_channels=nc_in)


NETG_NAMES = ("resnet_9blocks", "resnet_6blocks", "unet_128", "unet_256", "unet_1024", "swinT",
              "swinT_old", "SwinTUnet", "SwinTResnet")


def build_hemit_netG(netG: str, img_size, nc_in: int = 3, nc_out: int = 3) -> nn.Module:
    """The whole ``get_generator_hemit`` dispatch, as the JAX
    ``build_hemit_netG`` (reference: hemit_models.py:16-110) at its
    defaults (batch norm, no dropout): ``netG`` is one of ``NETG_NAMES``."""
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    if netG in ("resnet_9blocks", "resnet_6blocks"):
        return ResnetGenerator(out_channels=nc_out, ngf=64,
                               n_blocks=9 if netG.endswith("9blocks") else 6, norm="batch",
                               in_channels=nc_in)
    if netG in ("unet_128", "unet_256", "unet_1024"):
        num_downs = {"unet_128": 7, "unet_256": 8, "unet_1024": 10}[netG]
        return UnetGenerator(out_channels=nc_out, num_downs=num_downs, ngf=64, norm="batch",
                             in_channels=nc_in)
    if netG == "swinT":
        from .hemit_hybrid import HybridSwinT

        return HybridSwinT(img_size, out_channels=nc_out, depths=(1, 1, 3, 1), window_size=8)
    if netG == "swinT_old":
        from .hemit_hybrid import HybridSwinT_2

        return HybridSwinT_2(img_size, out_channels=nc_out, depths=(2, 2, 6, 2), window_size=8)
    if netG == "SwinTUnet":
        from .hemit_hybrid import SwinUnetGenerator

        # the factory's patch 32 / window 64 at 1024 px, the patch scaled with
        # the crop so that the Swin taps land on the U-Net's 16/8/4 levels
        return SwinUnetGenerator(img_size, out_channels=nc_out,
                                 num_downs=int(np.log2(img_size[0])),
                                 patch_size=max(1, img_size[0] // 32), window_size=64)
    if netG == "SwinTResnet":
        return build_hemit(img_size, nc_in, nc_out)
    raise NotImplementedError(f"unknown netG {netG!r}")
