"""MIPHEI-ViT generator: ViT foundation encoder + detail-capture decoder (PyTorch).

Counterpart of ``mipheivit_tpu/models/mipheivit.py``. Public functions take
NHWC ``[B, H, W, 3]`` and return NHWC f32 ``[B, H, W, C]``, as in JAX;
inside, the decoder runs NCHW (a permuted NHWC tensor is channels_last in
memory, which cuDNN prefers). Module and parameter names follow the
reference torch layout (``decoder.convstream.convs.{i}.conv/bn``,
``decoder.fusion_blks.{i}.conv.conv/bn``,
``decoder.segmentation_head_{k}.0.psi.{0,1,3}`` / ``.1``).

BatchNorm computes in f32 and returns the activation dtype, so bf16 weights
with f32 running statistics work; in training it follows flax's BatchNorm
(see ``layers.BatchNorm2d``). Convolutions cast their weights to the activation
dtype at use, as the flax modules do, so a decoder trained in f32 runs in
bf16 beside a bf16 encoder.

int8 serving: ``infer.loading.quantize_decoder`` swaps the four fusion
blocks' convolutions for ``Int8Conv3x3`` (the JAX ``_Int8Im2ColConv``:
``ops.quant.int8_conv3x3``); the detail stream and the heads keep the
compute dtype, as in JAX.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import int8_conv3x3, patch_width, quantize_weight
from ..ops.resize import resize_bicubic, upsample2x_bilinear
from ..ops.seg_heads import fold_heads, fused_seg_heads
from .layers import BatchNorm2d, Conv2d
from .vit import ViTConfig, VisionTransformer


def flatten_conv3x3_weight(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv weight ``[K, C, 3, 3]`` -> ``[K, 9C]`` in the ``(dy, dx, c)``
    order of ``ops.quant``'s im2col patches (the JAX
    ``flatten_conv3x3_kernel``, transposed)."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


class Int8Conv3x3(nn.Module):
    """Serving-only W8A8 3x3 / stride-1 conv without bias (the JAX
    ``_Int8Im2ColConv``). Its buffers: the int8 ``weight`` ``[K, 9C']``,
    flattened in the ``(dy, dx, c)`` order of the im2col patches and
    zero-padded to ``9C' = ops.quant.patch_width(C)`` once, so that a call
    neither reorders nor pads it; and the per-output-channel f32 ``scale``,
    quantised in the flattened layout so that each scale spans the im2col
    contraction (``from_conv``). ``ops.quant.int8_conv3x3`` quantises the
    patches per output pixel at each call."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(out_chans, patch_width(in_chans),
                                                   dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_chans))

    @classmethod
    def from_conv(cls, conv: nn.Conv2d) -> "Int8Conv3x3":
        """``conv``'s weight quantised as it stands, on its device."""
        k, c = conv.weight.shape[:2]
        with torch.device("meta"):
            q = cls(c, k)
        w_i8, q.scale = quantize_weight(flatten_conv3x3_weight(conv.weight.detach()), axis=-1)
        q.weight = F.pad(w_i8, (0, patch_width(c) - 9 * c))
        return q

    def forward(self, x):
        return int8_conv3x3(x, self.weight, self.scale)


class BasicConv3x3(nn.Module):
    """conv3x3 (no bias) + BN + ReLU (reference: mipheivit.py:20-41)."""

    def __init__(self, in_chans: int, out_chans: int, stride: int = 2):
        super().__init__()
        self.conv = Conv2d(in_chans, out_chans, 3, stride, 1, bias=False)
        self.bn = BatchNorm2d(out_chans)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvStream(nn.Module):
    """Detail stream D1..D3 at strides 2/4/8 (reference: mipheivit.py:44-73)."""

    def __init__(self, in_chans: int = 3, out_chans: Sequence[int] = (48, 96, 192)):
        super().__init__()
        chans = (in_chans,) + tuple(out_chans)
        self.convs = nn.ModuleList(BasicConv3x3(chans[i], chans[i + 1])
                                   for i in range(len(out_chans)))

    def forward(self, x):
        feats = [x]  # D0 = raw input
        for conv in self.convs:
            x = conv(x)
            feats.append(x)
        return feats


class FusionBlock(nn.Module):
    """up(x2, bilinear) -> concat(detail, up) -> conv3x3-BN-ReLU
    (reference: mipheivit.py:76-93)."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.conv = BasicConv3x3(in_chans, out_chans, stride=1)

    def forward(self, x, detail):
        return self.conv(torch.cat([detail, upsample2x_bilinear(x)], dim=1))


class AttentionGate(nn.Module):
    """Sigmoid spatial gate ``x * psi(x)`` (reference: unet.py:407-422)."""

    def __init__(self, chans: int):
        super().__init__()
        self.psi = nn.Sequential(
            Conv2d(chans, chans // 2, 1), BatchNorm2d(chans // 2), nn.ReLU(),
            Conv2d(chans // 2, 1, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.psi(x)


_ACTIVATIONS = {"tanh": nn.Tanh, "sigmoid": nn.Sigmoid}


class SegmentationHead(nn.Sequential):
    """Attention gate (or nothing) + conv3x3 + activation (reference:
    unet.py:425-438; the JAX ``SegmentationHead``): ``activation`` is
    "tanh", "sigmoid" or anything else for none. Slot 0 holds the gate or
    an ``nn.Identity``, slot 1 the conv, as in the reference layout."""

    def __init__(self, chans: int, use_attention: bool = True, activation: str = "tanh",
                 out_channels: int = 1):
        act = _ACTIVATIONS.get(activation, nn.Identity)
        super().__init__(AttentionGate(chans) if use_attention else nn.Identity(),
                         Conv2d(chans, out_channels, 3, padding=1), act())


class BatchedSegHeads(nn.Module):
    """All K attention-gated heads in one pass (the JAX ``BatchedSegHeads``).

    The K psi gates are one 1x1 conv to K*C/2 channels, BN, ReLU and one
    grouped 1x1 conv to K gates. The K final 3x3 convs use
    ``y_k(p) = sum_D m(p+D)[D, k] * g_k(p+D)`` with ``m`` one 1x1 conv to the
    tap-major 9*K channels. Built from K ``SegmentationHead``s by
    ``infer.loading.to_fast_heads``; numerically the same function.

    Eval mode folds the running-statistics BatchNorm into psi-conv1 and runs
    ``ops.seg_heads.fused_seg_heads``: K3 on the card, its plain version on
    the CPU. The folded weights are kept while the module's tensors stay as
    they are (same storage, same version), so serving folds once. Training
    mode runs the batch-statistics chain, ``chain`` (the JAX package's kernel
    is gated off in training too)."""

    def __init__(self, chans: int, heads: int):
        super().__init__()
        c2 = chans // 2
        self.heads = heads
        self.psi_conv1 = Conv2d(chans, heads * c2, 1)
        self.psi_bn = BatchNorm2d(heads * c2)
        self.psi_conv2 = Conv2d(heads * c2, heads, 1, groups=heads)
        # row (dy*3 + dx)*K + k holds head k's 3x3 tap (dy, dx); padding 1
        # makes its output the zero-bordered [H+2, W+2] map the taps slide over
        self.conv_taps = Conv2d(chans, 9 * heads, 1, padding=1, bias=False)
        self.conv_bias = nn.Parameter(torch.zeros(heads))
        self._folded = None     # (key, the tensors it was made from, fold_heads' tuple)

    def forward(self, x):
        if not self.training:
            # a decoder run from a 1x1 feature map (inputs under 32 px) loses
            # the channels_last layout; K3 reads channels_last rows
            x = x.contiguous(memory_format=torch.channels_last)
            return fused_seg_heads(x, *self._fold(x.dtype))
        return self.chain(x)

    def _fold(self, dtype):
        """``fold_heads(self, dtype)``, kept while every parameter and buffer
        keeps its storage and version. Folded afresh, and not kept, where a
        gradient may flow to the weights or they are inference tensors."""
        ts = list(self.parameters()) + list(self.buffers())
        if (any(t.is_inference() for t in ts)
                or (torch.is_grad_enabled() and any(t.requires_grad for t in ts))):
            return fold_heads(self, dtype)
        key = (dtype, torch.is_inference_mode_enabled(),
               tuple((t.data_ptr(), t._version) for t in ts))
        if self._folded is None or self._folded[0] != key:
            # the source tensors are held, so that no other tensor can take
            # their addresses while the key names them
            with torch.no_grad():
                self._folded = (key, [t.detach() for t in ts], fold_heads(self, dtype))
        return self._folded[2]

    def chain(self, x):
        """The plain chain: 1x1 convs, the BatchNorm (batch statistics in
        training, running ones in eval), nine ``addcmul_``. Training runs
        it; ``chip_smoke.py`` times it in eval as K3's library yardstick."""
        b, _, h, w = x.shape
        k = self.heads
        g = F.relu(self.psi_bn(self.psi_conv1(x)))
        gate = F.pad(torch.sigmoid(self.psi_conv2(g)), (1, 1, 1, 1))   # [B, K, H+2, W+2]
        m = self.conv_taps(x)                                            # [B, 9K, H+2, W+2]
        out = torch.empty((b, k, h, w), dtype=torch.float32, device=x.device,
                          memory_format=torch.channels_last)
        out.copy_(self.conv_bias.float()[:, None, None].expand(b, k, h, w))
        for dy in range(3):
            for dx in range(3):
                t = (dy * 3 + dx) * k
                out.addcmul_(m[:, t:t + k, dy:dy + h, dx:dx + w],
                             gate[:, :, dy:dy + h, dx:dx + w])
        return torch.tanh(out).to(x.dtype)


class DetailCapture(nn.Module):
    """ConvStream + 4 fusion blocks + per-marker heads
    (reference: mipheivit.py:166-220). Takes and returns NCHW."""

    def __init__(self, in_chans: int, out_chans: int = 16,
                 convstream_out: Sequence[int] = (48, 96, 192),
                 fusion_out: Sequence[int] = (256, 128, 64, 32),
                 fast_heads: bool = False):
        super().__init__()
        self.out_chans = out_chans
        self.convstream = ConvStream(3, convstream_out)
        detail = (3,) + tuple(convstream_out)
        fus = (in_chans,) + tuple(fusion_out)
        self.fusion_blks = nn.ModuleList(
            FusionBlock(fus[i] + detail[-(i + 1)], fus[i + 1])
            for i in range(len(fusion_out)))
        self.fast_heads = fast_heads
        if fast_heads:
            self.heads = BatchedSegHeads(fusion_out[-1], out_chans)
        else:
            for k in range(out_chans):
                self.add_module(f"segmentation_head_{k}", SegmentationHead(fusion_out[-1]))

    def forward(self, features, images):
        details = self.convstream(images)
        x = features
        n = len(self.fusion_blks)
        for i, blk in enumerate(self.fusion_blks):
            x = blk(x, details[n - i - 1])
        if self.fast_heads:
            return self.heads(x)
        return torch.cat([getattr(self, f"segmentation_head_{k}")(x)
                          for k in range(self.out_chans)], dim=1)


class Encoder(nn.Module):
    """ViT -> drop prefix tokens -> NCHW grid -> bicubic re-grid to /16
    (reference: mipheivit.py:124-163)."""

    def __init__(self, vit_cfg: ViTConfig):
        super().__init__()
        self.vit = VisionTransformer(vit_cfg)

    def forward(self, x):
        cfg = self.vit.cfg
        tokens = self.vit(x)[:, cfg.num_prefix_tokens:]
        gh, gw = cfg.grid_size
        feats = tokens.transpose(1, 2).reshape(tokens.shape[0], cfg.embed_dim, gh, gw)
        target = (cfg.img_size[0] // 16, cfg.img_size[1] // 16)
        if target != (gh, gw):
            feats = resize_bicubic(feats, target)
        # the decoder runs channels_last: torch's NCHW bilinear upsample loops
        # over all channels in each thread (40 ms on the 1536-channel map at
        # batch 64 on an H100), its NHWC kernel and cuDNN's bf16 convs do not
        return feats.contiguous(memory_format=torch.channels_last)


class MipheiViT(nn.Module):
    """Full generator. Input ``[B, H, W, 3]`` normalized H&E; output
    ``[B, H, W, C]`` f32 in (-1, 1). H and W are powers of two >= 128
    (reference: mipheivit.py:115-121)."""

    def __init__(self, vit_cfg: ViTConfig, out_chans: int = 16, fast_heads: bool = False):
        super().__init__()
        self.out_chans = out_chans
        self.encoder = Encoder(vit_cfg)
        self.decoder = DetailCapture(vit_cfg.embed_dim, out_chans, fast_heads=fast_heads)

    @property
    def vit_cfg(self) -> ViTConfig:
        return self.encoder.vit.cfg

    def forward(self, x):
        feats = self.encoder(x)
        images = x.to(feats.dtype).permute(0, 3, 1, 2)
        out = self.decoder(feats, images)
        return out.permute(0, 2, 3, 1).float()


def check_input_size(img_size: Tuple[int, int]) -> None:
    """Power-of-two >= 128 constraint (reference: mipheivit.py:115-121)."""
    for s in img_size:
        if s == 0 or (s & (s - 1)) != 0:
            raise ValueError("Both height and width must be powers of 2")
        if s < 128:
            raise ValueError("Height and width must be >= 128")
