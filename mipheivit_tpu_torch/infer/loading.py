"""Generator construction + checkpoint loading for inference (PyTorch).

Counterpart of ``mipheivit_tpu/infer/loading.py`` and the reference load
path (src/inference.py:134-153), for the flagship and the UNETR on a ViT:
prefer ``model.safetensors`` (strict=False
with ``validate_load`` rules, foundation encoder possibly stripped and then
grafted from the encoder checkpoint), fall back to the Lightning
``model.weights.ckpt`` (``generator.`` prefix). The serving transforms
(``to_fast_heads``, ``merge_lora``, ``cast_params``, and the opt-in int8
``quantize_encoder`` / ``quantize_decoder``) change the model in place and
return it.
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
from ..models.layers import Conv2d, Linear
from ..models.mipheivit import BatchedSegHeads, Int8Conv3x3, MipheiViT
from ..models.vit import Attention, Int8Linear, LoRAQKV, VisionTransformer
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


def _init_missing_lora(state: Dict, cfg, prefix: str) -> None:
    """A checkpoint without adapters gets the JAX package's fresh ones:
    A from ``np.random.default_rng(block)``, B = 0 (import_weights.py:195-201).
    ``prefix`` is the ViT's (``encoder.vit.``, ``encoder.model.``)."""
    if cfg.lora_rank <= 0:
        return
    for i in range(cfg.depth):
        for lq in ("lora_q", "lora_v"):
            base = f"{prefix}blocks.{i}.attn.qkv.{lq}"
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


def quantize_encoder(model: torch.nn.Module) -> torch.nn.Module:
    """Opt-in W8A8 serving transform of the ViT encoder (the JAX
    ``quantize_encoder``, infer/loading.py:91): every block's qkv, proj, fc1
    and fc2 becomes an ``Int8Linear`` (per-output-channel int8 weight, f32
    scale, the bias kept) and the float weight it replaces is freed.
    LayerNorms, layerscale, the patch
    embedding, attention and the decoder keep the compute dtype.

    Apply it after ``merge_lora`` and after ``cast_params``: the weights are
    quantised from the values they hold (bf16 weights from their bf16
    values, as the JAX transform quantises what ``load_generator`` returns).
    Raises ``ValueError`` on a model without a ViT encoder (``encoder.vit``,
    as JAX's :103), on live LoRA adapters, and on a tensor-parallel encoder
    (quantise before ``shard_params``: a row-split weight's per-output scale
    spans the whole contraction)."""
    from ..parallel.sharding import param_layouts

    vit = getattr(getattr(model, "encoder", None), "vit", None)
    if not isinstance(vit, VisionTransformer):
        raise ValueError("quantize_encoder requires a ViT-encoder model")
    if param_layouts(vit):
        raise ValueError("quantize_encoder quantises a whole encoder: call it before shard_params")
    if any(isinstance(m, LoRAQKV) for m in vit.modules()):
        raise ValueError("quantize_encoder quantises the merged qkv: call merge_lora first")
    with torch.no_grad():
        for blk in vit.blocks:
            for parent, name in ((blk.attn, "qkv"), (blk.attn, "proj"),
                                 (blk.mlp, "fc1"), (blk.mlp, "fc2")):
                lin = getattr(parent, name)
                if isinstance(lin, Linear):
                    setattr(parent, name, Int8Linear.from_linear(lin))
    return model


def quantize_decoder(model: torch.nn.Module) -> torch.nn.Module:
    """Opt-in W8A8 for the decoder's fusion convs (the JAX
    ``quantize_decoder``, infer/loading.py:125): each fusion block's 3x3
    conv becomes an ``Int8Conv3x3``, quantised in the flattened im2col
    layout so that each output channel's scale spans its contraction; the
    float weight is freed. The detail stream and the heads keep the compute
    dtype (their gates multiply the output directly). Compose after
    ``quantize_encoder`` for the full serving mode. Raises ``ValueError``
    on a model that is not the flagship."""
    if not isinstance(model, MipheiViT):
        raise ValueError("quantize_decoder quantises MipheiViT's fusion blocks")
    with torch.no_grad():
        for blk in model.decoder.fusion_blks:
            if isinstance(blk.conv.conv, Conv2d):
                blk.conv.conv = Int8Conv3x3.from_conv(blk.conv.conv)
    return model


def load_strict(model: torch.nn.Module, state: Dict) -> torch.nn.Module:
    """``load_state_dict`` that tolerates only BatchNorm's
    ``num_batches_tracked`` missing; returns the model."""
    tensors = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
               for k, v in state.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"checkpoint does not fit {type(model).__name__}: missing {missing[:8]}, "
                         f"unexpected {list(unexpected)[:8]}")
    return model


def load_vit_encoder(cfg, state: Dict, device=None, dtype=torch.float32) -> VisionTransformer:
    """A foundation ``VisionTransformer`` of ``cfg`` from a timm-layout
    state dict (the JAX package's ``vit_params_from_torch``), loaded
    strictly: the position embedding re-gridded to ``cfg``'s grid, plain
    ``attn.qkv`` names wrapped where the model has LoRA (fresh adapters
    where the state has none). In eval mode on ``device`` (the card unless
    the caller asks for the CPU), parameters in ``dtype``."""
    device = resolve_device(device)
    model = VisionTransformer(cfg)
    state = _wrap_qkv_names(dict(state), set(model.state_dict()))
    if "pos_embed" in state and state["pos_embed"].shape != model.pos_embed.shape:
        n_prefix = 0 if cfg.no_embed_class else cfg.num_prefix_tokens
        state["pos_embed"] = resample_pos_embed(state["pos_embed"].float(), cfg.grid_size,
                                                n_prefix)
    _init_missing_lora(state, cfg, "")
    load_strict(model, state)
    return cast_params(model.to(device).eval(), dtype)


def imports_reference_checkpoint(model: torch.nn.Module) -> bool:
    """Whether ``load_generator`` imports a reference-layout checkpoint into
    ``model``'s family: the flagship and the UNETR on a ViT, as the JAX
    ``load_generator`` (infer/loading.py:207-235)."""
    from ..models.unetr import UnetrViT

    return isinstance(model, (MipheiViT, UnetrViT))


def _import_reference(model: torch.nn.Module, checkpoint_dir,
                      encoder_ckpt_path: Optional[str]) -> torch.nn.Module:
    """Load a reference-layout checkpoint dir into ``model`` (one that
    ``imports_reference_checkpoint``), whole or foundation-stripped with the
    encoder file grafted in."""
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

    if isinstance(model, MipheiViT):
        prefix, vit = "encoder.vit.", model.encoder.vit
    else:
        prefix, vit = "encoder.model.", model.encoder.model
    cfg = vit.cfg
    enc_present = any(k.startswith(prefix) and ".lora" not in k for k in state)
    if not enc_present:
        if not encoder_ckpt_path or not Path(encoder_ckpt_path).exists():
            raise ValueError(
                "Checkpoint has the foundation encoder stripped; pass "
                "encoder_ckpt_path with the raw foundation checkpoint.")
        encoder = load_state_dict(encoder_ckpt_path)
        state = {**{f"{prefix}{k}": v for k, v in encoder.items()}, **state}
    model_keys = set(model.state_dict())
    state = _wrap_qkv_names(state, model_keys)
    pos_key = f"{prefix}pos_embed"
    if pos_key in state and state[pos_key].shape != vit.pos_embed.shape:
        n_prefix = 0 if cfg.no_embed_class else cfg.num_prefix_tokens
        state[pos_key] = resample_pos_embed(state[pos_key].float(), cfg.grid_size, n_prefix)
    _init_missing_lora(state, cfg, prefix)

    missing, unexpected = model.load_state_dict(state, strict=False)
    validate_load(missing, unexpected)
    return model


def load_generator(model_name: str, encoder_name: str, checkpoint_dir,
                   img_size, nc_out: int, dtype=torch.float32, device=None,
                   encoder_ckpt_path: Optional[str] = None,
                   fast_heads: bool = True, dropout: float = 0.0) -> torch.nn.Module:
    """Build the generator on ``device``, load a reference-layout checkpoint
    dir, and return it in eval mode with parameters in ``dtype``. ``device``
    defaults to the card and raises without one (``device="cpu"`` for the
    CPU).

    As the JAX ``load_generator`` (infer/loading.py:207-235): the flagship
    (foundation ViT under ``encoder.vit.``) and the UNETR on a ViT
    (``encoder.model.``) load, each whole or foundation-stripped with the
    encoder file grafted in; every other family (the SMP U-Net, the Swin
    and ResNet-50 UNETRs, HEMIT) raises ``NotImplementedError``.
    ``fast_heads`` applies to the flagship alone (K3 is on no other
    family's path). ``dropout`` is the config's ``model.dropout`` (it acts
    only in training)."""
    device = resolve_device(device)
    model = get_generator(model_name, img_size, nc_out, encoder_name,
                          dtype=torch.float32, device=device, dropout=dropout)
    if not imports_reference_checkpoint(model):
        raise NotImplementedError(
            f"checkpoint import not implemented for {model_name!r} ({encoder_name}), as in "
            "the JAX package")
    _import_reference(model, checkpoint_dir, encoder_ckpt_path)
    if fast_heads and isinstance(model, MipheiViT):
        to_fast_heads(model)
    return cast_params(model, dtype)


def load_trainer_export(model_name: str, encoder_name: str, checkpoint_dir, img_size,
                        nc_out: int, dtype=torch.float32, device=None,
                        encoder_ckpt_path: Optional[str] = None,
                        foreground_head: bool = False) -> torch.nn.Module:
    """The generator of a trainer's checkpoint dir in eval mode with
    parameters in ``dtype``: the families ``load_generator`` imports load
    as it loads them (unfused heads); every other family loads from the
    trainer's own export, ``model.safetensors`` in the model's layout,
    strictly (the JAX ``load_generator`` refuses them, so its
    ``test_model`` cannot evaluate them)."""
    device = resolve_device(device)
    model = get_generator(model_name, img_size, nc_out, encoder_name, dtype=torch.float32,
                          device=device, foreground_head=foreground_head)
    if imports_reference_checkpoint(model):
        _import_reference(model, checkpoint_dir, encoder_ckpt_path)
    else:
        load_strict(model, load_state_dict(Path(checkpoint_dir) / "model.safetensors"))
    return cast_params(model.eval(), dtype)
