"""Weights across the two packages, and the reference checkpoint rules.

``state_dict_from_jax`` turns the JAX package's variables (nested dicts of
numpy arrays: ``{"params", "batch_stats"}``) into a state dict in the
reference torch layout, which is the port's own module layout. It produces
what ``mipheivit_tpu.train.checkpoints.mipheivit_state_dict`` exports, key
for key, and it also reads the JAX-only layouts: scanned ``blocks`` (one
leading depth axis) as well as ``blocks_{i}``, and the fused ``heads``
decoder as well as per-head ``segmentation_head_{k}``.

It also maps part of a tree: the trainable sub-tree of a JAX ``TrainState``
(LoRA adapters and decoder, as ``partition_params`` splits it), its
``batch_stats``, or a gradient tree of the same shape. Entries the tree does
not hold are left out of the state dict. ``discriminator_state_dict_from_jax``
maps ``DiscriminatorPatch`` variables, spectral-norm ``u`` included.
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


def _get(tree, *path):
    """``tree[path[0]][path[1]]...``, or None where the tree stops."""
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _vit_state_dict(params: Dict, cfg: ViTConfig, prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def put(key, val, fn=np.asarray):
        if val is not None:
            out[prefix + key] = fn(val)

    put("patch_embed.proj.weight", _get(params, "patch_embed", "kernel"), _conv)
    put("patch_embed.proj.bias", _get(params, "patch_embed", "bias"))
    if cfg.class_token:
        put("cls_token", _get(params, "cls_token"))
    if cfg.reg_tokens:
        put("reg_token", _get(params, "reg_token"))
    put("pos_embed", _get(params, "pos_embed"))
    put("norm.weight", _get(params, "norm", "scale"))
    put("norm.bias", _get(params, "norm", "bias"))

    qkv = "attn.qkv.qkv" if cfg.lora_rank > 0 else "attn.qkv"
    for i in range(cfg.depth):
        layer = _index(params["blocks"], i) if "blocks" in params else params[f"blocks_{i}"]
        base = f"blocks.{i}."
        for name, path, fn in (
                ("norm1.weight", ("norm1", "scale"), np.asarray),
                ("norm1.bias", ("norm1", "bias"), np.asarray),
                ("norm2.weight", ("norm2", "scale"), np.asarray),
                ("norm2.bias", ("norm2", "bias"), np.asarray),
                (f"{qkv}.weight", ("attn", "qkv", "kernel"), _t),
                (f"{qkv}.bias", ("attn", "qkv", "bias"), np.asarray),
                ("attn.proj.weight", ("attn", "proj", "kernel"), _t),
                ("attn.proj.bias", ("attn", "proj", "bias"), np.asarray),
                ("mlp.fc1.weight", ("mlp", "fc1", "kernel"), _t),
                ("mlp.fc1.bias", ("mlp", "fc1", "bias"), np.asarray),
                ("mlp.fc2.weight", ("mlp", "fc2", "kernel"), _t),
                ("mlp.fc2.bias", ("mlp", "fc2", "bias"), np.asarray)):
            put(base + name, _get(layer, *path), fn)
        if cfg.init_values is not None:
            put(base + "ls1.gamma", _get(layer, "ls1"))
            put(base + "ls2.gamma", _get(layer, "ls2"))
        if cfg.lora_rank > 0:
            for lq in ("lora_q", "lora_v"):
                put(base + f"attn.qkv.{lq}.A", _get(layer, "attn", lq, "A"))
                put(base + f"attn.qkv.{lq}.B", _get(layer, "attn", lq, "B"))
    return out


def _per_head(params: Dict, stats: Dict, out_chans: int):
    """The decoder's heads as K per-head (params, stats) pairs, from either
    the per-head or the fused ``heads`` layout."""
    if "heads" not in params and "heads" not in stats:
        return [(_get(params, f"segmentation_head_{k}"), _get(stats, f"segmentation_head_{k}"))
                for k in range(out_chans)]
    if "heads" not in params:
        raise ValueError("map the fused heads' batch_stats together with their params")
    hp, hs = params["heads"], stats.get("heads", {})
    c2 = np.asarray(hp["psi_conv1_bias"]).shape[-1]

    def part(a, k):
        return None if a is None else np.asarray(a)[k * c2:(k + 1) * c2]

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
        s = {"attention": {"psi_bn": {"mean": part(_get(hs, "psi_bn", "mean"), k),
                                      "var": part(_get(hs, "psi_bn", "var"), k)}}}
        heads.append((p, s))
    return heads


def _decoder_state_dict(params: Dict, stats: Dict, out_chans: int,
                        prefix: str = "decoder.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def put(key, val, fn=np.asarray):
        if val is not None:
            out[key] = fn(val)

    def put_conv(key, p, bias=True):
        put(key + ".weight", _get(p, "kernel"), _conv)
        if bias:
            put(key + ".bias", _get(p, "bias"))

    def put_bn(key, p, s):
        put(key + ".weight", _get(p, "scale"))
        put(key + ".bias", _get(p, "bias"))
        put(key + ".running_mean", _get(s, "mean"))
        put(key + ".running_var", _get(s, "var"))
        if _get(s, "mean") is not None:
            out[key + ".num_batches_tracked"] = np.asarray(0, np.int64)

    tree = params if params else stats
    n_stream = sum(k.startswith("convs_") for k in tree["convstream"])
    for i in range(n_stream):
        p = _get(params, "convstream", f"convs_{i}")
        s = _get(stats, "convstream", f"convs_{i}", "bn")
        put_conv(f"{prefix}convstream.convs.{i}.conv", _get(p, "conv"), bias=False)
        put_bn(f"{prefix}convstream.convs.{i}.bn", _get(p, "bn"), s)
    n_fusion = sum(k.startswith("fusion_blks_") for k in tree)
    for i in range(n_fusion):
        p = _get(params, f"fusion_blks_{i}", "conv")
        s = _get(stats, f"fusion_blks_{i}", "conv", "bn")
        put_conv(f"{prefix}fusion_blks.{i}.conv.conv", _get(p, "conv"), bias=False)
        put_bn(f"{prefix}fusion_blks.{i}.conv.bn", _get(p, "bn"), s)
    for k, (p, s) in enumerate(_per_head(params, stats, out_chans)):
        base = f"{prefix}segmentation_head_{k}"
        put_conv(f"{base}.0.psi.0", _get(p, "attention", "psi_conv1"))
        put_bn(f"{base}.0.psi.1", _get(p, "attention", "psi_bn"),
               _get(s, "attention", "psi_bn"))
        put_conv(f"{base}.0.psi.3", _get(p, "attention", "psi_conv2"))
        put_conv(f"{base}.1", _get(p, "conv"))
    return out


def state_dict_from_jax(variables: Dict, vit_cfg: ViTConfig,
                        out_chans: int = 16) -> Dict[str, np.ndarray]:
    """JAX variables -> reference-layout state dict of numpy arrays.

    ``variables`` holds a ``MipheiViT`` (``params["encoder"]["vit"]`` and
    ``params["decoder"]``) or a bare ``VisionTransformer`` (its params at the
    top level, no ``batch_stats`` needed), whole or in part (see the module
    docstring; ``params`` may be ``{}`` to map ``batch_stats`` alone).
    ``vit_cfg.lora_rank`` decides, as in the JAX exporter, whether qkv is
    named in the LoRA-wrapped layout."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    if params and "encoder" not in params and "decoder" not in params:
        return _vit_state_dict(params, vit_cfg, "")
    out = {}
    if _get(params, "encoder", "vit") is not None:
        out.update(_vit_state_dict(params["encoder"]["vit"], vit_cfg, "encoder.vit."))
    if params.get("decoder") or stats.get("decoder"):
        out.update(_decoder_state_dict(params.get("decoder", {}), stats.get("decoder", {}),
                                       out_chans))
    return out


def discriminator_state_dict_from_jax(variables: Dict) -> Dict[str, np.ndarray]:
    """JAX ``DiscriminatorPatch`` variables (``params`` and ``spectral``) ->
    the port's ``DiscriminatorPatch`` state dict: ``conv{n}`` then
    ``conv_out`` become ``convs.{i}`` (weight OIHW, bias, power-iteration
    ``u``)."""
    params, spectral = variables["params"], variables.get("spectral", {})
    names = sorted((k for k in params if k != "conv_out"), key=lambda k: int(k[len("conv"):]))
    out = {}
    for i, name in enumerate(names + ["conv_out"]):
        out[f"convs.{i}.weight"] = _conv(params[name]["kernel"])
        if "bias" in params[name]:
            out[f"convs.{i}.bias"] = np.asarray(params[name]["bias"])
        out[f"convs.{i}.u"] = np.asarray(spectral[name]["u"])
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
