"""Swin Transformer in timm's layout (PyTorch): ctranspath and the HEMIT
Swin branches.

Counterpart of ``mipheivit_tpu/models/swin.py`` (reference: timm
``swin_tiny_patch4_window7_224``, with ctranspath's conv stem,
src/generators/foundation_models.py:161-184, 321-367). Module and parameter
names are timm's newer layout, downsample first in each stage:
``patch_embed.proj`` (a ``Sequential`` of conv, BN, ReLU, conv, BN, ReLU,
1x1 conv for the conv stem), ``patch_embed.norm``,
``layers.{s}.downsample.{norm,reduction}``,
``layers.{s}.blocks.{b}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}`` and ``norm``;
with LoRA, qkv is the reference's wrapper (``attn.qkv.qkv``,
``attn.qkv.lora_{q,v}.{A,B}``). ``models.import_hemit`` maps ctranspath's
and the older timm's keys onto these.

Window attention adds a relative-position bias and, in shifted blocks, the
-100 mask to its logits, so no kernel of the port computes it: it runs as
plain PyTorch, f32 logits from the activations' dtype (the JAX einsum's
``preferred_element_type=f32``) and a softmax, as it runs as XLA in JAX.

A block's window is ``min(window, H, W)`` of its grid, as in JAX, so the
bias tables are sized at construction from ``SwinConfig.img_size``; a block
raises on a grid that needs another window. The shift gate is JAX's
``min(H, W) > window`` (on non-square grids timm decides per dimension;
ROADMAP.md queue 3). Images are NCHW at the call; the features come back
NHWC, as timm's stages hold them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, FrozenBatchNorm2d, LayerNorm, Linear
from .vit import LoRAQKV


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 4
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    conv_stem: bool = False      # ctranspath's ConvStem
    lora_rank: int = 0
    lora_alpha: float = 1.0
    in_chans: int = 3            # the hybrids' Swin reads a CNN map (JAX infers it)

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)

    def stage_grid(self, i: int) -> Tuple[int, int]:
        """The token grid of stage ``i`` at ``img_size``."""
        h, w = self.img_size
        if self.conv_stem:      # two 3x3 stride-2 convs with padding 1: ceil(n / 2) twice
            h, w = (-(-(-(-n // 2)) // 2) for n in (h, w))
        else:
            h, w = h // self.patch_size, w // self.patch_size
        return h >> i, w >> i

    def replace(self, **kw) -> "SwinConfig":
        return dataclasses.replace(self, **kw)


def _rel_pos_index(window: int) -> np.ndarray:
    """``[w*w, w*w]`` index of each query-key offset into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """``[nW, w*w, w*w]`` additive mask (0 or -100) of shifted-window
    attention on a padded ``hp x wp`` grid."""
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(hp // window, window, wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _index_on(window: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_rel_pos_index(window).reshape(-1)).to(device)


@functools.lru_cache(maxsize=32)
def _mask_on(hp: int, wp: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_shift_attn_mask(hp, wp, window, shift)).to(device)


def softmax_attention(q, k, v, bias=None):
    """``softmax(q k^T / sqrt(d) + bias) v`` on ``[..., H, N, D]``: the
    logits in f32 (f64 for f64 operands) from the operands' dtype (exact
    products, f32 sums: JAX's ``preferred_element_type=f32``), the
    probabilities cast back before the product with v. ``bias`` broadcasts
    against ``[..., H, N, M]``."""
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


class WindowAttention(nn.Module):
    """Multi-head attention within each window, with the relative-position
    bias table and LoRA on q and v."""

    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool = True,
                 lora_rank: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        self.num_heads, self.window, self.head_dim = num_heads, window, dim // num_heads
        if lora_rank > 0:
            self.qkv = LoRAQKV(dim, lora_rank, lora_alpha, qkv_bias)
        else:
            self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)

    def attend(self, q, k, v, table, mask: Optional[torch.Tensor] = None):
        """The windows' attention of ``q, k, v [bw, n, heads * head_dim]`` at
        ``self.num_heads`` heads, ``table`` their columns of the bias
        table: ``[bw, n, heads * head_dim]`` before the projection."""
        bw, n, _ = q.shape
        h, hd = self.num_heads, self.head_dim
        q, k, v = (t.reshape(bw, n, h, hd).transpose(1, 2) for t in (q, k, v))
        table = table.to(torch.promote_types(q.dtype, torch.float32))
        bias = table[_index_on(self.window, q.device)].reshape(n, n, -1).permute(2, 0, 1)
        if mask is not None:
            # windows as [images, nW]: the mask broadcasts over the images
            nw = mask.shape[0]
            q, k, v = (t.reshape(bw // nw, nw, h, n, hd) for t in (q, k, v))
            bias = bias[None] + mask[:, None]
        out = softmax_attention(q, k, v, bias).reshape(bw, h, n, hd)
        return out.transpose(1, 2).reshape(bw, n, h * hd)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if isinstance(self.qkv, LoRAQKV):
            q, k, v = self.qkv(x)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(self.attend(q, k, v, self.relative_position_bias_table, mask))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-norm (shifted-)window attention and GELU MLP on ``[B, H, W, C]``:
    pad to a multiple of the window, roll, partition, attend, merge,
    unroll, crop (JAX ``SwinBlock``)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float,
                 qkv_bias: bool, grid: Tuple[int, int], lora_rank: int = 0,
                 lora_alpha: float = 1.0):
        super().__init__()
        # the configured window, and the one this block's grid gives
        self.window, self.shift = window, shift
        self.grid_window = min(window, *grid)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, self.grid_window, qkv_bias, lora_rank,
                                    lora_alpha)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        win = min(self.window, h, w)
        if win != self.grid_window:
            raise ValueError(f"a {h}x{w} grid needs window {win}; this block was built for "
                             f"window {self.grid_window} (SwinConfig.img_size)")
        shift = self.shift if min(h, w) > win else 0
        shortcut = x
        x = self.norm1(x)
        pad_h, pad_w = (win - h % win) % win, (win - w % win) % win
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _mask_on(hp, wp, win, shift, x.device)
        x = x.reshape(b, hp // win, win, wp // win, win, c).transpose(2, 3)
        x = self.attn(x.reshape(-1, win * win, c), mask)
        x = x.reshape(b, hp // win, wp // win, win, win, c).transpose(2, 3).reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in timm's order, LayerNorm, linear
    ``4C -> out`` without bias."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * in_dim)
        self.reduction = Linear(4 * in_dim, out_dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, downsample: Optional[nn.Module], blocks: List[nn.Module]):
        super().__init__()
        if downsample is not None:
            self.downsample = downsample
        self.blocks = nn.ModuleList(blocks)


class PatchEmbed(nn.Module):
    """A p x p stride-p conv, or ctranspath's conv stem (two 3x3 stride-2
    convs without bias, each with a BatchNorm on its running statistics
    even in training, and ReLU; then a 1x1 conv), then LayerNorm. NCHW in,
    NHWC out."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        e = cfg.embed_dim
        if cfg.conv_stem:
            d = e // 8
            self.proj = nn.Sequential(
                Conv2d(cfg.in_chans, d, 3, 2, 1, bias=False), FrozenBatchNorm2d(d), nn.ReLU(),
                Conv2d(d, 2 * d, 3, 2, 1, bias=False), FrozenBatchNorm2d(2 * d), nn.ReLU(),
                Conv2d(2 * d, e, 1))
        else:
            self.proj = Conv2d(cfg.in_chans, e, cfg.patch_size, cfg.patch_size)
        self.norm = LayerNorm(e)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """NCHW image -> (final-normed NHWC tokens, the per-stage NHWC taps).

    ``collect="stage_out"`` taps each stage after its blocks (timm
    ``forward_intermediates``); ``"post_downsample"`` taps stages 1..n-1
    after their downsample, before their blocks (the HEMIT dual branch),
    and stops there: what follows feeds nothing, so the first output is
    None (in JAX it is computed and dropped). The input is cast to
    ``compute_dtype`` (None: the patch embedding's weight dtype)."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype: Optional[torch.dtype] = None
        self.patch_embed = PatchEmbed(cfg)
        layers = []
        for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            dim = cfg.stage_dim(si)
            blocks = [SwinBlock(dim, heads, cfg.window_size,
                                0 if bi % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio,
                                cfg.qkv_bias, cfg.stage_grid(si), cfg.lora_rank,
                                cfg.lora_alpha)
                      for bi in range(depth)]
            layers.append(SwinStage(PatchMerging(cfg.stage_dim(si - 1), dim) if si else None,
                                    blocks))
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(cfg.stage_dim(cfg.num_stages - 1))

    def forward(self, x, collect: str = "stage_out"):
        dtype = self.compute_dtype or next(self.patch_embed.parameters()).dtype
        x = self.patch_embed(x.to(dtype))
        feats = []
        last = len(self.layers) - 1
        for si, stage in enumerate(self.layers):
            if si > 0:
                x = stage.downsample(x)
                if collect == "post_downsample":
                    feats.append(x)
                    if si == last:
                        return None, feats
            for blk in stage.blocks:
                x = blk(x)
            if collect == "stage_out":
                feats.append(x)
        return self.norm(x), feats
