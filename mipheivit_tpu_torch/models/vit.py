"""Vision Transformer for the pathology foundation encoders (PyTorch).

Counterpart of ``mipheivit_tpu/models/vit.py``: DINOv2-style ViTs with
optional register tokens, layerscale, packed-SwiGLU or GELU MLPs,
``no_embed_class`` position embeddings, and LoRA adapters on the q and v
slices of the fused qkv projection. Module and parameter names follow the
reference torch layout (timm's ``patch_embed.proj``, ``blocks.{i}.attn.qkv``
..., and the LoRA wrapper's ``attn.qkv.qkv`` / ``attn.qkv.lora_q.A``), so a
released checkpoint loads with ``load_state_dict``.

Attention runs through ``ops.attention``: K1 (S <= 512) or K4 on the card,
the plain versions on the CPU, each with its backward (the plain recompute
for K1, K5 for K4). The SwiGLU MLP's fc1 and gate run through
``ops.mlp.swiglu_fc1``: K2 on the card, its plain version on the CPU, with
a recompute backward.

Training. LoRA stays live (``attn.qkv.lora_q`` / ``lora_v`` trainable, cast
to the activation dtype at use, as is every LayerScale), and
``VisionTransformer.grad_checkpointing`` recomputes each block in the
backward (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations. The JAX package's remat-policy menu is TPU machinery and has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import attention_bshd, attention_qkv
from ..ops.mlp import swiglu_fc1


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 14
    embed_dim: int = 1536
    depth: int = 40
    num_heads: int = 24
    mlp_hidden_dim: int = 4096       # true hidden width (post-gate for swiglu)
    mlp_type: str = "swiglu"          # "swiglu" | "gelu"
    init_values: Optional[float] = 1e-5   # layerscale init; None = no layerscale
    class_token: bool = True
    reg_tokens: int = 4
    no_embed_class: bool = True
    qkv_bias: bool = True
    norm_eps: float = 1e-6
    lora_rank: int = 0
    lora_alpha: float = 1.0

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size,
                self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.reg_tokens

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


class LoRA(nn.Module):
    """``alpha * x @ A @ B`` with A ~ N(0,1)/sqrt(r), B = 0
    (reference: src/generators/lora.py:8-18)."""

    def __init__(self, in_dim: int, out_dim: int, rank: int, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha
        self.A = nn.Parameter(torch.randn(in_dim, rank) / rank ** 0.5)
        self.B = nn.Parameter(torch.zeros(rank, out_dim))

    def forward(self, x):
        return self.alpha * ((x @ self.A.to(x.dtype)) @ self.B.to(x.dtype))


class LoRAQKV(nn.Module):
    """The reference's LoRA wrapper around the fused qkv Linear: adapters on
    the q and v slices (reference: src/generators/lora.py:21-33)."""

    def __init__(self, dim: int, rank: int, alpha: float, bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=bias)
        self.lora_q = LoRA(dim, dim, rank, alpha)
        self.lora_v = LoRA(dim, dim, rank, alpha)

    def forward(self, x):
        """Returns the adapted q, k, v, each ``[B, S, dim]``."""
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return q + self.lora_q(x), k, v + self.lora_v(x)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        if cfg.lora_rank > 0:
            self.qkv = LoRAQKV(d, cfg.lora_rank, cfg.lora_alpha, cfg.qkv_bias)
        else:
            self.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.proj = nn.Linear(d, d)

    def forward(self, x):
        if isinstance(self.qkv, LoRAQKV):
            # LoRA live: q and v differ from the fused buffer's sections
            out = attention_bshd(*self.qkv(x), self.num_heads)
        else:
            # merged or absent: K1 reads q | k | v in place off one buffer
            out = attention_qkv(self.qkv(x), self.num_heads)
        return self.proj(out)


class Mlp(nn.Module):
    """Packed SwiGLU (timm SwiGLUPacked: ``silu(first half) * second half``)
    or GELU MLP. The SwiGLU fc1 and gate run as one ``ops.mlp.swiglu_fc1``
    (K2 on the card) on fc1's packed weight, whose layout is unchanged."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.mlp_type not in ("swiglu", "gelu"):
            raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
        self.swiglu = cfg.mlp_type == "swiglu"
        h = cfg.mlp_hidden_dim
        self.fc1 = nn.Linear(cfg.embed_dim, 2 * h if self.swiglu else h)
        self.fc2 = nn.Linear(h, cfg.embed_dim)

    def forward(self, x):
        if self.swiglu:
            h = swiglu_fc1(x, self.fc1.weight, self.fc1.bias)
        else:
            h = F.gelu(self.fc1(x))
        return self.fc2(h)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.mlp = Mlp(cfg)
        if cfg.init_values is None:
            self.ls1 = self.ls2 = nn.Identity()
        else:
            self.ls1 = LayerScale(d, cfg.init_values)
            self.ls2 = LayerScale(d, cfg.init_values)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class VisionTransformer(nn.Module):
    """NHWC image ``[B, H, W, 3]`` (already normalized) -> tokens
    ``[B, num_prefix_tokens + gh*gw, embed_dim]`` after the final norm.

    ``intermediates`` (block indices) also returns the un-normed token
    sequence after those blocks, as the JAX module does. Input is cast to
    the dtype of the parameters. With ``grad_checkpointing`` set and grad
    enabled, each block's activations are recomputed in the backward."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.grad_checkpointing = False
        d, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, p, stride=p)
        if cfg.class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        if cfg.reg_tokens:
            self.reg_token = nn.Parameter(torch.zeros(1, cfg.reg_tokens, d))
        n_pos = cfg.num_patches + (0 if cfg.no_embed_class else cfg.num_prefix_tokens)
        self.pos_embed = nn.Parameter(torch.randn(1, n_pos, d) * 0.02)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.norm_eps)

    def forward(self, x, intermediates: Sequence[int] = ()):
        cfg = self.cfg
        w = self.patch_embed.proj.weight
        x = self.patch_embed.proj(x.to(w.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                  # [B, gh*gw, d]
        b = x.shape[0]
        prefix = []
        if cfg.class_token:
            prefix.append(self.cls_token.to(x.dtype).expand(b, -1, -1))
        if cfg.reg_tokens:
            prefix.append(self.reg_token.to(x.dtype).expand(b, -1, -1))
        pos = self.pos_embed.to(x.dtype)
        if cfg.no_embed_class:
            # pos embed covers patch tokens only; prefix tokens get none
            x = torch.cat(prefix + [x + pos], dim=1)
        else:
            x = torch.cat(prefix + [x], dim=1) + pos
        taps = []
        ckpt = self.grad_checkpointing and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            x = torch.utils.checkpoint.checkpoint(blk, x, use_reentrant=False) if ckpt else blk(x)
            if i in intermediates:
                taps.append(x)
        x = self.norm(x)
        if intermediates:
            return x, taps
        return x
