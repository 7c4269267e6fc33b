"""HEMIT zoo: the three Swin hybrid baseline generators (PyTorch).

Counterpart of ``mipheivit_tpu/models/hemit_hybrid.py`` (reference:
src/generators/hemit_models.py): ``HybridSwinT`` (:489, netG ``swinT``),
``HybridSwinT_2`` (:684, ``swinT_old``) and ``SwinUnetGenerator`` (:800,
``SwinTUnet``). Each pairs a CNN branch with a timm Swin. As in JAX, the
Swin's grid comes from the actual input (the CNN branch's output for the
first two), not from the reference constructors' ``img_size``; here it is
fixed at construction from ``img_size``, since the Swin's window tables
depend on it, and ``out_channels`` is honoured.

Module and parameter names are the HEMIT codebase's, which the JAX
importers read: ``cnn_block.{4i,4i+1}`` (conv, BN of each Sequential
stage), ``model.*`` (timm Swin), ``decoder.upsample_and_conv{k}.1``,
``decoder.conv{k}``, ``decoder.upsample{k}``,
``decoder.final_upsample_layers.{i}``; for the U-Net
``down_layers.{i}.{0,2}``, ``up_layers.{i}.{0,2}``, ``final_layer.0``,
``swinT.*``, ``cross_atts.{j}.{gate.0, norm_swinT, linear_swinT,
transformer_unet.layers.0.{0,1}.*}``.

The bilinear x2 upsamples have ``align_corners=True`` (the reference's
``nn.Upsample``). Attention (the Swin's windows, the Cross_Att block) is
plain PyTorch with f32 logits; no kernel of the port is on these paths.
Public forwards take NHWC and return NHWC f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.resize import upsample2x_bilinear
from .layers import BatchNorm2d, Conv2d, ConvTranspose2d, LayerNorm, Linear
from .swin import SwinConfig, SwinTransformer, softmax_attention


class Upsample2xAlignCorners(nn.Module):
    """``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)``."""

    def forward(self, x):
        return upsample2x_bilinear(x, align_corners=True)


def _up_conv(in_ch: int, out_ch: int) -> nn.Sequential:
    """Upsample x2 (align corners) then conv3x3 pad 1: slot 1 is the conv."""
    return nn.Sequential(Upsample2xAlignCorners(), Conv2d(in_ch, out_ch, 3, padding=1))


def _cnn_stage(in_ch: int, out_ch: int):
    """Conv3x3 + BN + ReLU + MaxPool2 (reference :506-514, :697-706)."""
    return [Conv2d(in_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch), nn.ReLU(), nn.MaxPool2d(2)]


def _conv3(in_ch: int, out_ch: int) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, padding=1)


def _pair(img_size):
    return (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)


class _Hybrid(nn.Module):
    """What the first two hybrids share: NHWC in, cast, the CNN front end,
    the Swin (stage-out taps, final-normed root) and NHWC f32 out."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dtype = self.compute_dtype or self.cnn_block[0].weight.dtype
        h = x.to(dtype).permute(0, 3, 1, 2)
        cnn_taps = []
        for i in range(0, len(self.cnn_block), 4):
            h = self.cnn_block[i:i + 4](h)
            cnn_taps.append(h)
        root, taps = self.model(h, collect="stage_out")
        nchw = [t.permute(0, 3, 1, 2) for t in taps]
        return torch.tanh(self.decode(root.permute(0, 3, 1, 2), nchw, cnn_taps)
                          ).permute(0, 2, 3, 1).float()


class HybridSwinT(_Hybrid):
    """CNN /8 front end -> Swin (patch 4) -> a decoder of bilinear
    up-convs over both branches' taps (reference :489-533, Decoder_hbrid
    :571-681)."""

    def __init__(self, img_size, out_channels: int = 3, cnn_channels: Sequence[int] = (16, 32, 64),
                 embed_dim: int = 96, depths: Sequence[int] = (1, 1, 3, 1),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 8,
                 patch_size: int = 4, in_channels: int = 3):
        super().__init__()
        self.cnn_channels, self.embed_dim = tuple(cnn_channels), embed_dim
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.window_size, self.patch_size = window_size, patch_size
        stages, prev = [], in_channels
        for ch in cnn_channels:
            stages += _cnn_stage(prev, ch)
            prev = ch
        self.cnn_block = nn.Sequential(*stages)
        h, w = _pair(img_size)
        n = 2 ** len(cnn_channels)
        self.model = SwinTransformer(SwinConfig(
            img_size=(h // n, w // n), patch_size=patch_size, embed_dim=embed_dim,
            depths=self.depths, num_heads=self.num_heads, window_size=window_size,
            qkv_bias=False, in_chans=prev))
        d, e, cnn = embed_dim * 2 ** (len(depths) - 1), embed_dim, cnn_channels
        c4 = (e // 4 + cnn[2]) // 2
        c5 = (c4 // 2 + cnn[1]) // 2
        c6 = (c5 // 2 + 1 + cnn[0]) // 2
        dec = self.decoder = nn.Module()
        ups = [(d, d // 2), (d // 2, d // 4), (d // 4, d // 8), (d // 8, e // 2), (e // 2, e // 4),
               (c4, c4 // 2), (c5, c5 // 2 + 1), (c6, out_channels)]
        for k, (i, o) in enumerate(ups, 1):
            dec.add_module(f"upsample_and_conv{k}", _up_conv(i, o))
        convs = [(d, d // 2), (d // 2, d // 4), (d // 4, d // 8), (e // 4 + cnn[2], c4),
                 (c4 // 2 + cnn[1], c5), (c5 // 2 + 1 + cnn[0], c6)]
        for k, (i, o) in enumerate(convs, 1):
            dec.add_module(f"conv{k}", _conv3(i, o))

    def decode(self, root, taps, cnn_taps):
        dec = self.decoder
        y = root
        for k, skip in ((1, taps[2]), (2, taps[1]), (3, taps[0])):
            y = getattr(dec, f"upsample_and_conv{k}")(y)
            y = getattr(dec, f"conv{k}")(torch.cat([y, skip], dim=1))
        y = dec.upsample_and_conv5(dec.upsample_and_conv4(y))
        y = dec.conv4(torch.cat([y, cnn_taps[2]], dim=1))
        y = dec.conv5(torch.cat([dec.upsample_and_conv6(y), cnn_taps[1]], dim=1))
        y = dec.conv6(torch.cat([dec.upsample_and_conv7(y), cnn_taps[0]], dim=1))
        return dec.upsample_and_conv8(y)


class HybridSwinT_2(_Hybrid):
    """CNN /4 front end -> Swin (patch 4) -> a decoder of k2 s2 transposed
    convs (reference :684-753, Decoder_hbrid_2 :756-797)."""

    def __init__(self, img_size, out_channels: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 8, patch_size: int = 4, in_channels: int = 3):
        super().__init__()
        self.embed_dim, self.depths, self.num_heads = embed_dim, tuple(depths), tuple(num_heads)
        self.window_size, self.patch_size = window_size, patch_size
        self.cnn_block = nn.Sequential(*_cnn_stage(in_channels, 32), *_cnn_stage(32, 64))
        h, w = _pair(img_size)
        self.model = SwinTransformer(SwinConfig(
            img_size=(h // 4, w // 4), patch_size=patch_size, embed_dim=embed_dim,
            depths=self.depths, num_heads=self.num_heads, window_size=window_size,
            qkv_bias=False, in_chans=64))
        d = embed_dim * 2 ** (len(depths) - 1)
        dec = self.decoder = nn.Module()
        for k in (1, 2, 3):
            dec.add_module(f"upsample{k}", ConvTranspose2d(d >> (k - 1), d >> k, 2, 2))
            dec.add_module(f"conv{k}", _conv3(2 * (d >> k), d >> k))
        n_final = int(np.log2(patch_size)) + 2
        dec.final_upsample_layers = nn.ModuleList(
            ConvTranspose2d(d // 8, out_channels if i == n_final - 1 else d // 8, 2, 2)
            for i in range(n_final))

    def decode(self, root, taps, cnn_taps):
        dec = self.decoder
        y = root
        for k, skip in ((1, taps[2]), (2, taps[1]), (3, taps[0])):
            y = getattr(dec, f"conv{k}")(torch.cat([getattr(dec, f"upsample{k}")(y), skip], dim=1))
        for up in dec.final_upsample_layers:
            y = up(y)
        return y


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(Linear(heads * dim_head, dim))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        out = softmax_attention(q, k, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # slot 2 stands for the reference's Dropout(0) (its last one is left out)
        self.net = nn.Sequential(Linear(dim, hidden), nn.GELU(), nn.Identity(),
                                 Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class ViTBlock(nn.Module):
    """The Cross_Att's one-block pre-norm transformer (reference
    Transformer / Attention / FeedForward :905-965): 3 heads of 32, MLP
    128, ``layers.0.0`` the attention, ``layers.0.1`` the MLP."""

    def __init__(self, dim: int, heads: int = 3, dim_head: int = 32, mlp_dim: int = 128):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            _PreNorm(dim, _Attention(dim, heads, dim_head)),
            _PreNorm(dim, _FeedForward(dim, mlp_dim))])])

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return x


class CrossAtt(nn.Module):
    """Gated summary-token fusion (reference Cross_Att :968-1005): the Swin
    tap, layer-normed and mean-pooled into one token projected to the U-Net
    width, is prepended to the U-Net tokens, one transformer block runs,
    and the result is gate-blended into the U-Net map. U-Net map NCHW, Swin
    tap NHWC."""

    def __init__(self, dim_unet: int, dim_swin: int):
        super().__init__()
        self.gate = nn.Sequential(Conv2d(dim_unet, dim_unet, 1), nn.Sigmoid())
        self.norm_swinT = LayerNorm(dim_swin)
        self.linear_swinT = Linear(dim_swin, dim_unet)
        self.transformer_unet = ViTBlock(dim_unet)

    def forward(self, unet_feat, swin_feat):
        b, cu, hu, wu = unet_feat.shape
        gate = self.gate(unet_feat)
        s = self.norm_swinT(swin_feat.reshape(b, -1, swin_feat.shape[-1])).mean(dim=1)
        s = self.linear_swinT(s)
        tokens = torch.cat([s[:, None], unet_feat.permute(0, 2, 3, 1).reshape(b, hu * wu, cu)], 1)
        attended = self.transformer_unet(tokens)[:, 1:].reshape(b, hu, wu, cu).permute(0, 3, 1, 2)
        return gate * attended + (1.0 - gate) * unet_feat


class SwinUnetGenerator(nn.Module):
    """A pix2pix-style deep U-Net whose 16/8/4-px skips fuse with a
    parallel Swin branch's post-downsample taps through ``CrossAtt``
    (reference :800-902). The Swin patch should be input/32 so that its
    taps land on those grids (the factory's patch 32 at 1024 px)."""

    def __init__(self, img_size, out_channels: int = 3, num_downs: int = 10, ngf: int = 64,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 64,
                 patch_size: int = 32, in_channels: int = 3):
        super().__init__()
        self.compute_dtype: Optional[torch.dtype] = None
        h, w = _pair(img_size)
        self.num_downs = num_downs
        self.tap_idx = [i for i in range(num_downs) if (h >> (i + 1)) in (16, 8, 4)]
        if len(self.tap_idx) != 3:
            raise ValueError(f"SwinUnetGenerator needs down levels at 16/8/4 px, got taps at "
                             f"{self.tap_idx} for input {h}")
        downs, prev = [], in_channels
        for i in range(num_downs):
            out = min(ngf * 2 ** i, ngf * 8)
            layers = [Conv2d(prev, out, 4, 2, 1), nn.LeakyReLU(0.2)]
            if i != num_downs - 1:                   # innermost: no norm
                layers.append(BatchNorm2d(out))
            downs.append(nn.Sequential(*layers))
            prev = out
        self.down_layers = nn.ModuleList(downs)
        self.swinT = SwinTransformer(SwinConfig(
            img_size=(h, w), patch_size=patch_size, embed_dim=embed_dim, depths=tuple(depths),
            num_heads=tuple(num_heads), window_size=window_size, qkv_bias=True,
            in_chans=in_channels))
        self.cross_atts = nn.ModuleList(CrossAtt(ngf * 8, embed_dim * 2 ** (j + 1))
                                        for j in range(3))
        # the reference's channel plan (:814-826), for any num_downs
        configs = ([(ngf * 8, ngf * 8)] + [(ngf * 16, ngf * 8)] * (num_downs - 5)
                   + [(ngf * 16, ngf * 4), (ngf * 8, ngf * 2), (ngf * 4, ngf)])
        self.up_layers = nn.ModuleList(
            nn.Sequential(ConvTranspose2d(i, o, 4, 2, 1), nn.ReLU(), BatchNorm2d(o))
            for i, o in configs)
        self.final_layer = nn.Sequential(ConvTranspose2d(2 * ngf, out_channels, 4, 2, 1),
                                         nn.Tanh())

    def forward(self, x):
        dtype = self.compute_dtype or self.final_layer[0].weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2)
        h, skips = x, []
        for layer in self.down_layers:
            h = layer(h)
            skips.append(h)
        skips = skips[:-1]
        _, taps = self.swinT(x, collect="post_downsample")
        for j, i in enumerate(self.tap_idx):
            skips[i] = self.cross_atts[j](skips[i], taps[j])
        for layer, skip in zip(self.up_layers, reversed(skips)):
            h = torch.cat([layer(h), skip], dim=1)
        return self.final_layer(h).permute(0, 2, 3, 1).float()
