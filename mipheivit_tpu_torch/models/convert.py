"""Weights across the two packages, and the reference checkpoint rules.

``state_dict_from_jax`` turns the JAX package's variables (nested dicts of
numpy arrays: ``{"params", "batch_stats"}``) into a state dict in the
reference torch layout, which is the port's own module layout. It produces
what ``mipheivit_tpu.train.checkpoints.mipheivit_state_dict`` exports, key
for key, and it also reads the JAX-only layouts: scanned ``blocks`` (one
leading depth axis) as well as ``blocks_{i}``, and the fused ``heads``
decoder as well as per-head ``segmentation_head_{k}``.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from .vit import ViTConfig


def _t(w) -> np.ndarray:
    """flax Dense kernel ``[in, out]`` -> torch Linear weight ``[out, in]``."""
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(k) -> np.ndarray:
    """flax conv kernel HWIO -> torch OIHW."""
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _index(tree, i):
    """Slice ``[i]`` off every leaf of a nested dict (scanned layer stack)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _vit_state_dict(params: Dict, cfg: ViTConfig, prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def put(key, val):
        out[prefix + key] = np.asarray(val)

    put("patch_embed.proj.weight", _conv(params["patch_embed"]["kernel"]))
    put("patch_embed.proj.bias", params["patch_embed"]["bias"])
    if cfg.class_token:
        put("cls_token", params["cls_token"])
    if cfg.reg_tokens:
        put("reg_token", params["reg_token"])
    put("pos_embed", params["pos_embed"])
    put("norm.weight", params["norm"]["scale"])
    put("norm.bias", params["norm"]["bias"])

    qkv = "attn.qkv.qkv" if cfg.lora_rank > 0 else "attn.qkv"
    for i in range(cfg.depth):
        layer = _index(params["blocks"], i) if "blocks" in params else params[f"blocks_{i}"]
        base = f"blocks.{i}."
        attn, mlp = layer["attn"], layer["mlp"]
        put(base + "norm1.weight", layer["norm1"]["scale"])
        put(base + "norm1.bias", layer["norm1"]["bias"])
        put(base + "norm2.weight", layer["norm2"]["scale"])
        put(base + "norm2.bias", layer["norm2"]["bias"])
        put(base + f"{qkv}.weight", _t(attn["qkv"]["kernel"]))
        put(base + f"{qkv}.bias", attn["qkv"]["bias"])
        put(base + "attn.proj.weight", _t(attn["proj"]["kernel"]))
        put(base + "attn.proj.bias", attn["proj"]["bias"])
        put(base + "mlp.fc1.weight", _t(mlp["fc1"]["kernel"]))
        put(base + "mlp.fc1.bias", mlp["fc1"]["bias"])
        put(base + "mlp.fc2.weight", _t(mlp["fc2"]["kernel"]))
        put(base + "mlp.fc2.bias", mlp["fc2"]["bias"])
        if cfg.init_values is not None:
            put(base + "ls1.gamma", layer["ls1"])
            put(base + "ls2.gamma", layer["ls2"])
        if cfg.lora_rank > 0 and "lora_q" in attn:
            for lq in ("lora_q", "lora_v"):
                put(base + f"attn.qkv.{lq}.A", attn[lq]["A"])
                put(base + f"attn.qkv.{lq}.B", attn[lq]["B"])
    return out


def _per_head(params: Dict, stats: Dict, out_chans: int):
    """The decoder's heads as K per-head (params, stats) pairs, from either
    the per-head or the fused ``heads`` layout."""
    if "heads" not in params:
        return [(params[f"segmentation_head_{k}"], stats[f"segmentation_head_{k}"])
                for k in range(out_chans)]
    hp, hs = params["heads"], stats["heads"]
    c2 = np.asarray(hp["psi_conv1_bias"]).shape[-1]

    def part(a, k):
        return np.asarray(a)[k * c2:(k + 1) * c2]

    heads = []
    for k in range(out_chans):
        p = {"attention": {
            "psi_conv1": {"kernel": np.asarray(hp["psi_conv1_kernel"])[k],
                          "bias": np.asarray(hp["psi_conv1_bias"])[k]},
            "psi_conv2": {"kernel": np.asarray(hp["psi_conv2_kernel"])[k],
                          "bias": np.asarray(hp["psi_conv2_bias"])[k]},
            "psi_bn": {"scale": part(hp["psi_bn"]["scale"], k),
                       "bias": part(hp["psi_bn"]["bias"], k)}},
            "conv": {"kernel": np.asarray(hp["conv_kernel"])[k],
                     "bias": np.asarray(hp["conv_bias"])[k]}}
        s = {"attention": {"psi_bn": {"mean": part(hs["psi_bn"]["mean"], k),
                                      "var": part(hs["psi_bn"]["var"], k)}}}
        heads.append((p, s))
    return heads


def _decoder_state_dict(params: Dict, stats: Dict, out_chans: int,
                        prefix: str = "decoder.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def put_conv(key, p, bias=True):
        out[key + ".weight"] = _conv(p["kernel"])
        if bias:
            out[key + ".bias"] = np.asarray(p["bias"])

    def put_bn(key, p, s):
        out[key + ".weight"] = np.asarray(p["scale"])
        out[key + ".bias"] = np.asarray(p["bias"])
        out[key + ".running_mean"] = np.asarray(s["mean"])
        out[key + ".running_var"] = np.asarray(s["var"])
        out[key + ".num_batches_tracked"] = np.asarray(0, np.int64)

    n_stream = sum(k.startswith("convs_") for k in params["convstream"])
    for i in range(n_stream):
        p = params["convstream"][f"convs_{i}"]
        s = stats["convstream"][f"convs_{i}"]
        put_conv(f"{prefix}convstream.convs.{i}.conv", p["conv"], bias=False)
        put_bn(f"{prefix}convstream.convs.{i}.bn", p["bn"], s["bn"])
    n_fusion = sum(k.startswith("fusion_blks_") for k in params)
    for i in range(n_fusion):
        p = params[f"fusion_blks_{i}"]["conv"]
        s = stats[f"fusion_blks_{i}"]["conv"]
        put_conv(f"{prefix}fusion_blks.{i}.conv.conv", p["conv"], bias=False)
        put_bn(f"{prefix}fusion_blks.{i}.conv.bn", p["bn"], s["bn"])
    for k, (p, s) in enumerate(_per_head(params, stats, out_chans)):
        base = f"{prefix}segmentation_head_{k}"
        put_conv(f"{base}.0.psi.0", p["attention"]["psi_conv1"])
        put_bn(f"{base}.0.psi.1", p["attention"]["psi_bn"], s["attention"]["psi_bn"])
        put_conv(f"{base}.0.psi.3", p["attention"]["psi_conv2"])
        put_conv(f"{base}.1", p["conv"])
    return out


def state_dict_from_jax(variables: Dict, vit_cfg: ViTConfig,
                        out_chans: int = 16) -> Dict[str, np.ndarray]:
    """JAX variables -> reference-layout state dict of numpy arrays.

    ``variables`` holds a ``MipheiViT`` (``params["encoder"]["vit"]`` and
    ``params["decoder"]``) or a bare ``VisionTransformer`` (its params at the
    top level, no ``batch_stats`` needed). ``vit_cfg.lora_rank`` decides, as
    in the JAX exporter, whether qkv is named in the LoRA-wrapped layout."""
    params = variables["params"]
    if "encoder" not in params:
        return _vit_state_dict(params, vit_cfg, "")
    out = _vit_state_dict(params["encoder"]["vit"], vit_cfg, "encoder.vit.")
    out.update(_decoder_state_dict(params["decoder"],
                                   variables.get("batch_stats", {}).get("decoder", {}),
                                   out_chans))
    return out


def generator_state_dict(state: Dict) -> Dict:
    """The generator of a Lightning checkpoint: ``generator.`` prefix and
    torch.compile's ``_orig_mod.`` stripped (reference: src/inference.py:79-84,
    src/utils.py:133-141)."""
    if any(k.startswith("generator.") for k in state):
        state = {k[len("generator."):]: v for k, v in state.items()
                 if k.startswith("generator.")}
    return {k.replace("_orig_mod.", ""): v for k, v in state.items()}


def validate_load(missing_keys: Iterable[str], unexpected_keys: Iterable[str]) -> None:
    """The reference's ``validate_load_info`` (src/inference.py:28-45): no
    unexpected key; a missing key is allowed only in the frozen foundation
    encoder, never a LoRA adapter."""
    unexpected_keys = list(unexpected_keys)
    if unexpected_keys:
        raise ValueError(f"Unexpected keys in state_dict: {unexpected_keys}")
    for key in missing_keys:
        if ".lora" in key:
            raise ValueError(f"Missing LoRA checkpoint in state_dict: {key}")
        if not any(part in key for part in ("encoder.vit.", "encoder.model.")):
            raise ValueError(f"Missing key in state_dict: {key}")
