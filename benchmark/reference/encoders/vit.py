"""timm's ViT as the port's ``models/vit.py`` lays it out, LoRA on q and v
(``LoRAQKV``: ``attn.qkv.qkv`` plus ``attn.qkv.lora_q`` / ``lora_v``)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.layers import attention, conv, layer_norm, linear


def grid(cfg, img: int) -> Tuple[int, int]:
    p = cfg["encoder"]["patch_size"]
    return img // p, img // p


def n_prefix(cfg) -> int:
    e = cfg["encoder"]
    return (1 if e["class_token"] else 0) + e["reg_tokens"]


def shapes(cfg, img: int, prefix: str) -> Dict[str, Tuple[int, ...]]:
    e = cfg["encoder"]
    d, p = e["embed_dim"], e["patch_size"]
    gh, gw = grid(cfg, img)
    n_pos = gh * gw + (0 if e["no_embed_class"] else n_prefix(cfg))
    hidden = e["mlp_hidden_dim"] * (2 if e["mlp_type"] == "swiglu" else 1)
    s = {f"{prefix}patch_embed.proj.weight": (d, 3, p, p), f"{prefix}patch_embed.proj.bias": (d,),
         f"{prefix}pos_embed": (1, n_pos, d), f"{prefix}norm.weight": (d,),
         f"{prefix}norm.bias": (d,)}
    if e["class_token"]:
        s[f"{prefix}cls_token"] = (1, 1, d)
    if e["reg_tokens"]:
        s[f"{prefix}reg_token"] = (1, e["reg_tokens"], d)
    r = cfg["lora_rank"]
    for i in range(e["depth"]):
        b = f"{prefix}blocks.{i}."
        qkv = f"{b}attn.qkv.qkv." if r else f"{b}attn.qkv."
        s.update({f"{b}norm1.weight": (d,), f"{b}norm1.bias": (d,), f"{qkv}weight": (3 * d, d),
                  f"{qkv}bias": (3 * d,), f"{b}attn.proj.weight": (d, d),
                  f"{b}attn.proj.bias": (d,), f"{b}norm2.weight": (d,), f"{b}norm2.bias": (d,),
                  f"{b}mlp.fc1.weight": (hidden, d), f"{b}mlp.fc1.bias": (hidden,),
                  f"{b}mlp.fc2.weight": (d, e["mlp_hidden_dim"]), f"{b}mlp.fc2.bias": (d,)})
        if e["init_values"] is not None:
            s[f"{b}ls1.gamma"] = (d,)
            s[f"{b}ls2.gamma"] = (d,)
        if r:
            for lq in ("lora_q", "lora_v"):
                s[f"{b}attn.qkv.{lq}.A"] = (d, r)
                s[f"{b}attn.qkv.{lq}.B"] = (r, d)
    return s


def block(cfg, p, pre: str, x, quant):
    e = cfg["encoder"]
    eps, heads, d = e["norm_eps"], e["num_heads"], e["embed_dim"]
    h = layer_norm(x, p, f"{pre}norm1", eps)
    if cfg["lora_rank"]:
        qkv = linear(h, p[f"{pre}attn.qkv.qkv.weight"], p[f"{pre}attn.qkv.qkv.bias"], quant)
        q, k, v = qkv.split(d, dim=-1)
        alpha = cfg["lora_alpha"]
        for name in ("q", "v"):
            a_, b_ = p[f"{pre}attn.qkv.lora_{name}.A"], p[f"{pre}attn.qkv.lora_{name}.B"]
            delta = alpha * (quant(quant(h) @ quant(a_)) @ quant(b_))
            q, v = (q + delta, v) if name == "q" else (q, v + delta)
    else:
        q, k, v = linear(h, p[f"{pre}attn.qkv.weight"], p[f"{pre}attn.qkv.bias"],
                         quant).split(d, dim=-1)
    a = linear(attention(q, k, v, heads, quant), p[f"{pre}attn.proj.weight"],
               p[f"{pre}attn.proj.bias"], quant)
    if e["init_values"] is not None:
        a = a * p[f"{pre}ls1.gamma"]
    x = x + a
    h = linear(layer_norm(x, p, f"{pre}norm2", eps), p[f"{pre}mlp.fc1.weight"],
               p[f"{pre}mlp.fc1.bias"], quant)
    if e["mlp_type"] == "swiglu":
        a_, g_ = h.chunk(2, dim=-1)
        h = F.silu(a_) * g_
    else:
        h = F.gelu(h)
    m = linear(h, p[f"{pre}mlp.fc2.weight"], p[f"{pre}mlp.fc2.bias"], quant)
    if e["init_values"] is not None:
        m = m * p[f"{pre}ls2.gamma"]
    return x + m


def forward(cfg, p, pre: str, x, quant, taps: Sequence[int] = (), checkpoint=False):
    """NHWC normalized images -> (tokens after the final norm, the un-normed
    tokens after the blocks in ``taps``)."""
    e = cfg["encoder"]
    t = conv(x.permute(0, 3, 1, 2), p[f"{pre}patch_embed.proj.weight"],
             p[f"{pre}patch_embed.proj.bias"], quant, stride=e["patch_size"])
    t = t.flatten(2).transpose(1, 2)
    b = t.shape[0]
    prefix = []
    if e["class_token"]:
        prefix.append(p[f"{pre}cls_token"].expand(b, -1, -1))
    if e["reg_tokens"]:
        prefix.append(p[f"{pre}reg_token"].expand(b, -1, -1))
    if e["no_embed_class"]:
        t = torch.cat(prefix + [t + p[f"{pre}pos_embed"]], dim=1)
    else:
        t = torch.cat(prefix + [t], dim=1) + p[f"{pre}pos_embed"]
    out = []
    for i in range(e["depth"]):
        blk_pre = f"{pre}blocks.{i}."
        if checkpoint and torch.is_grad_enabled():
            t = torch.utils.checkpoint.checkpoint(
                lambda z, bp=blk_pre: block(cfg, p, bp, z, quant), t, use_reentrant=False)
        else:
            t = block(cfg, p, blk_pre, t, quant)
        if i in taps:
            out.append(t)
    return layer_norm(t, p, f"{pre}norm", e["norm_eps"]), out


def features(cfg, tokens, img: int):
    """``[B, S, D]`` tokens -> the patch grid ``[B, D, gh, gw]``, the prefix
    dropped."""
    gh, gw = grid(cfg, img)
    b = tokens.shape[0]
    return tokens[:, n_prefix(cfg):].transpose(1, 2).reshape(b, cfg["encoder"]["embed_dim"],
                                                             gh, gw)


def merged(cfg, p: Dict[str, torch.Tensor]):
    """The LoRA adapters folded into the qkv weights in f32, for serving:
    ``W_q += alpha (A_q B_q)^T``, the same for v. Returns the configuration
    without LoRA and the merged tensors."""
    if not cfg["lora_rank"]:
        return cfg, p
    d = cfg["encoder"]["embed_dim"]
    out = {}
    for n, t in p.items():
        if ".lora_" in n:
            continue
        if n.endswith("attn.qkv.qkv.weight") or n.endswith("attn.qkv.qkv.bias"):
            base = n[:-len("qkv.weight")] if n.endswith("weight") else n[:-len("qkv.bias")]
            new = n.replace("attn.qkv.qkv.", "attn.qkv.")
            if n.endswith("weight"):
                w = t.float().clone()
                for lq, sl in (("lora_q", slice(0, d)), ("lora_v", slice(2 * d, 3 * d))):
                    w[sl] += cfg["lora_alpha"] * (p[f"{base}{lq}.A"].float()
                                                  @ p[f"{base}{lq}.B"].float()).T
                out[new] = w
            else:
                out[new] = t
            continue
        out[n] = t
    return dict(cfg, lora_rank=0), out
