"""Generator construction + checkpoint loading for inference (PyTorch).

Counterpart of ``mipheivit_tpu/infer/loading.py`` and the reference load
path (src/inference.py:134-153): prefer ``model.safetensors`` (strict=False
with ``validate_load`` rules, foundation encoder possibly stripped and then
grafted from the encoder checkpoint), fall back to the Lightning
``model.weights.ckpt`` (``generator.`` prefix). The serving transforms
(``to_fast_heads``, ``merge_lora``, ``cast_params``) change the model in
place and return it.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..io.safetensors import load_file
from ..models import get_generator
from ..models.convert import generator_state_dict, validate_load
from ..models.mipheivit import BatchedSegHeads, MipheiViT
from ..models.vit import Attention, LoRAQKV, VisionTransformer
from ..ops.resize import resample_pos_embed


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a flat ``{name: tensor}`` dict: safetensors
    through the stdlib reader, torch pickles with ``weights_only=True``."""
    path = str(path)
    if path.endswith(".safetensors"):
        return load_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def _wrap_qkv_names(state: Dict, model_keys) -> Dict:
    """Plain timm ``attn.qkv.{weight,bias}`` -> the LoRA wrapper's
    ``attn.qkv.qkv.{weight,bias}`` where the model has the wrapper
    (reference: import_weights.py:307-328)."""
    out = {}
    for k, v in state.items():
        m = re.match(r"(.*blocks\.\d+\.attn\.qkv)\.(weight|bias)$", k)
        wrapped = f"{m.group(1)}.qkv.{m.group(2)}" if m else None
        out[wrapped if wrapped in model_keys and wrapped not in state else k] = v
    return out


def _init_missing_lora(state: Dict, model: MipheiViT) -> None:
    """A checkpoint without adapters gets the JAX package's fresh ones:
    A from ``np.random.default_rng(block)``, B = 0 (import_weights.py:195-201)."""
    cfg = model.vit_cfg
    for i in range(cfg.depth):
        for lq in ("lora_q", "lora_v"):
            base = f"encoder.vit.blocks.{i}.attn.qkv.{lq}"
            if f"{base}.A" in state:
                continue
            rng = np.random.default_rng(i)
            state[f"{base}.A"] = torch.from_numpy(
                (rng.standard_normal((cfg.embed_dim, cfg.lora_rank))
                 / np.sqrt(cfg.lora_rank)).astype(np.float32))
            state[f"{base}.B"] = torch.zeros(cfg.lora_rank, cfg.embed_dim)


def to_fast_heads(model: MipheiViT) -> MipheiViT:
    """Replace the K per-marker heads by one ``BatchedSegHeads`` (the same
    function, one pass over the feature map; counterpart of
    ``stack_head_params``)."""
    dec = model.decoder
    if dec.fast_heads:
        return model
    heads = [getattr(dec, f"segmentation_head_{k}") for k in range(dec.out_chans)]
    gates = [h[0].psi for h in heads]
    w = heads[0][1].weight
    with torch.device(w.device):
        fast = BatchedSegHeads(w.shape[1], dec.out_chans)
    k = dec.out_chans
    with torch.no_grad():
        fast.psi_conv1.weight.copy_(torch.cat([g[0].weight for g in gates]))
        fast.psi_conv1.bias.copy_(torch.cat([g[0].bias for g in gates]))
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(fast.psi_bn, name).copy_(torch.cat([getattr(g[1], name) for g in gates]))
        fast.psi_conv2.weight.copy_(torch.cat([g[3].weight for g in gates]))
        fast.psi_conv2.bias.copy_(torch.cat([g[3].bias for g in gates]))
        taps = torch.stack([h[1].weight[0] for h in heads])          # [K, C, 3, 3]
        fast.conv_taps.weight.copy_(
            taps.permute(2, 3, 0, 1).reshape(9 * k, -1)[:, :, None, None])
        fast.conv_bias.copy_(torch.cat([h[1].bias for h in heads]))
    cast_params(fast, w.dtype)
    for i in range(k):
        delattr(dec, f"segmentation_head_{i}")
    dec.heads = fast.train(dec.training)
    dec.fast_heads = True
    return model


def merge_lora(model: torch.nn.Module) -> torch.nn.Module:
    """Fold the LoRA adapters into the fused qkv weights, in f32:
    ``W_q += alpha * (A_q @ B_q)^T`` and the same for v (loading.py:47-88).
    Each wrapper is replaced by its inner Linear and each ViT config's
    ``lora_rank`` becomes 0, so attention takes the fused K1 path. Works on
    the generator or a bare ``VisionTransformer``."""
    with torch.no_grad():
        for mod in model.modules():
            if not isinstance(mod, Attention) or not isinstance(mod.qkv, LoRAQKV):
                continue
            wrap, lin = mod.qkv, mod.qkv.qkv
            d = lin.in_features
            w = lin.weight.float()
            for lora, sl in ((wrap.lora_q, slice(0, d)), (wrap.lora_v, slice(2 * d, 3 * d))):
                w[sl] += lora.alpha * (lora.A.float() @ lora.B.float()).T
            lin.weight.copy_(w.to(lin.weight.dtype))
            mod.qkv = lin
    for mod in model.modules():
        if isinstance(mod, VisionTransformer):
            mod.cfg = mod.cfg.replace(lora_rank=0)
    return model


def cast_params(model: torch.nn.Module, dtype) -> torch.nn.Module:
    """Cast the floating parameters to ``dtype``; buffers (BatchNorm running
    statistics) stay f32 (loading.py:162-185)."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


def load_generator(model_name: str, encoder_name: str, checkpoint_dir,
                   img_size, nc_out: int, dtype=torch.float32, device=None,
                   encoder_ckpt_path: Optional[str] = None,
                   fast_heads: bool = True) -> MipheiViT:
    """Build the generator on ``device``, load a reference-layout checkpoint
    dir, and return it in eval mode with parameters in ``dtype``. ``device``
    defaults to the card and raises without one (``device="cpu"`` for the
    CPU)."""
    device = resolve_device(device)
    ckpt_dir = Path(checkpoint_dir)
    st_path = ckpt_dir / "model.safetensors"
    ckpt_path = ckpt_dir / "model.weights.ckpt"
    if st_path.exists():
        state = load_state_dict(st_path)
    elif ckpt_path.exists():
        state = load_state_dict(ckpt_path)
    else:
        raise FileNotFoundError(
            f"no model.safetensors or model.weights.ckpt in {checkpoint_dir}")
    state = generator_state_dict(state)

    model = get_generator(model_name, img_size, nc_out, encoder_name,
                          dtype=torch.float32, device=device)
    cfg = model.vit_cfg
    enc_present = any(k.startswith("encoder.vit.") and ".lora" not in k for k in state)
    if not enc_present:
        if not encoder_ckpt_path or not Path(encoder_ckpt_path).exists():
            raise ValueError(
                "Checkpoint has the foundation encoder stripped; pass "
                "encoder_ckpt_path with the raw foundation checkpoint.")
        encoder = load_state_dict(encoder_ckpt_path)
        state = {**{f"encoder.vit.{k}": v for k, v in encoder.items()}, **state}
    model_keys = set(model.state_dict())
    state = _wrap_qkv_names(state, model_keys)
    pos_key = "encoder.vit.pos_embed"
    want = model.encoder.vit.pos_embed.shape
    if pos_key in state and state[pos_key].shape != want:
        n_prefix = 0 if cfg.no_embed_class else cfg.num_prefix_tokens
        state[pos_key] = resample_pos_embed(state[pos_key].float(), cfg.grid_size, n_prefix)
    _init_missing_lora(state, model)

    missing, unexpected = model.load_state_dict(state, strict=False)
    validate_load(missing, unexpected)
    if fast_heads:
        to_fast_heads(model)
    return cast_params(model, dtype)
