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
``unetr_state_dict_from_jax``, ``unetr_swin_state_dict_from_jax``,
``unet_resnet50_state_dict_from_jax``, ``smp_unet_state_dict_from_jax``,
``swin_state_dict_from_jax``, ``hemit_state_dict_from_jax`` (the HEMIT zoo's
generators and discriminators) map the baseline generators the same way:
flax ``ConvTranspose`` kernels are flipped into torch's layout, ``Dense``
kernels transposed, LayerNorm ``scale`` becomes ``weight`` and BatchNorm
``mean`` / ``var`` the running buffers.

The int8 serving trees of the JAX transforms (``quantize_encoder``,
``quantize_decoder``) map onto a ``MipheiViT`` after the port's own
transforms (``infer.loading.quantize_encoder`` / ``quantize_decoder``): an
int8 Dense ``kernel`` becomes the int8 ``weight`` of ``Int8Linear``
(transposed like a float one), an int8 fusion conv ``kernel`` the flattened,
zero-padded ``weight`` of ``Int8Conv3x3``, each beside its f32 ``scale``.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from ..ops.quant import patch_width
from .vit import ViTConfig


def _t(w) -> np.ndarray:
    """flax Dense kernel ``[in, out]`` -> torch Linear weight ``[out, in]``."""
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(k) -> np.ndarray:
    """flax conv kernel HWIO -> torch OIHW."""
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _int8_conv(k) -> np.ndarray:
    """JAX int8 conv kernel ``(3, 3, C, K)`` -> ``Int8Conv3x3.weight``
    ``[K, patch_width(C)]``: flattened in ``(dy, dx, c)`` order, transposed,
    zero columns past 9C."""
    k = np.asarray(k)
    c = k.shape[2]
    w = k.reshape(9 * c, -1).T
    return np.ascontiguousarray(np.pad(w, ((0, 0), (0, patch_width(c) - 9 * c))))


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
                ("mlp.fc2.bias", ("mlp", "fc2", "bias"), np.asarray),
                # int8 serving trees: the per-output-channel scales
                (f"{qkv}.scale", ("attn", "qkv", "scale"), np.asarray),
                ("attn.proj.scale", ("attn", "proj", "scale"), np.asarray),
                ("mlp.fc1.scale", ("mlp", "fc1", "scale"), np.asarray),
                ("mlp.fc2.scale", ("mlp", "fc2", "scale"), np.asarray)):
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
        scale = _get(p, "conv", "scale")
        put(f"{prefix}fusion_blks.{i}.conv.conv.weight", _get(p, "conv", "kernel"),
            _conv if scale is None else _int8_conv)
        put(f"{prefix}fusion_blks.{i}.conv.conv.scale", scale)
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


def _convT(k) -> np.ndarray:
    """flax ``ConvTranspose`` kernel ``[kh, kw, in, out]`` (stored
    un-flipped: flax correlates) -> torch ``ConvTranspose2d`` weight
    ``[in, out, kh, kw]``; the inverse of import_weights.py:353-358."""
    return np.ascontiguousarray(np.asarray(k).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


class _Emitter:
    """Writes torch names from (possibly partial) flax sub-trees: entries the
    tree does not hold are left out."""

    def __init__(self):
        self.out: Dict[str, np.ndarray] = {}

    def put(self, key, val, fn=np.asarray):
        if val is not None:
            self.out[key] = fn(val)

    def conv(self, key, p, fn=_conv):
        self.put(key + ".weight", _get(p, "kernel"), fn)
        self.put(key + ".bias", _get(p, "bias"))

    def norm(self, key, p, s=None):
        """LayerNorm, or BatchNorm with its running statistics in ``s``."""
        self.put(key + ".weight", _get(p, "scale"))
        self.put(key + ".bias", _get(p, "bias"))
        self.put(key + ".running_mean", _get(s, "mean"))
        self.put(key + ".running_var", _get(s, "var"))
        if _get(s, "mean") is not None:
            self.out[key + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def conv_block(self, key, p, s):
        """``unetr.Conv2DBlock``: ``block.0`` conv, ``block.1`` BN."""
        self.conv(key + ".block.0", _get(p, "conv"))
        self.norm(key + ".block.1", _get(p, "bn"), _get(s, "bn"))

    def deconv_block(self, key, p, s):
        """``unetr.Deconv2DBlock``: ``block.0`` transposed conv, ``block.1``
        conv, ``block.2`` BN."""
        self.conv(key + ".block.0", _get(p, "deconv"), _convT)
        self.conv(key + ".block.1", _get(p, "conv"))
        self.norm(key + ".block.2", _get(p, "bn"), _get(s, "bn"))

    def head(self, key, p, s):
        """``SegmentationHead``: the gate's ``0.psi.{0,1,3}`` (if any), the
        conv ``1``."""
        self.conv(f"{key}.0.psi.0", _get(p, "attention", "psi_conv1"))
        self.norm(f"{key}.0.psi.1", _get(p, "attention", "psi_bn"),
                  _get(s, "attention", "psi_bn"))
        self.conv(f"{key}.0.psi.3", _get(p, "attention", "psi_conv2"))
        self.conv(f"{key}.1", _get(p, "conv"))

    def heads(self, params, stats, names):
        for name in names:
            self.head(name, _get(params, name), _get(stats, name))

    def cellvit_decoder(self, p, s):
        self.conv("decoder.bottleneck_upsampler", _get(p, "bottleneck_upsampler"), _convT)
        for stage, n_blocks in (("decoder3", 3), ("decoder2", 2), ("decoder1", 2)):
            base = f"decoder.{stage}_upsampler"
            for b in range(n_blocks):
                self.conv_block(f"{base}.{b}", _get(p, f"{stage}_{b}"), _get(s, f"{stage}_{b}"))
            self.conv(f"{base}.{n_blocks}", _get(p, f"{stage}_up"), _convT)
        for b in range(2):
            self.conv_block(f"decoder.decoder0_header.{b}", _get(p, f"decoder0_{b}"),
                            _get(s, f"decoder0_{b}"))
        self.conv("decoder.decoder0_header.2", _get(p, "decoder0_out"))

    def resnet(self, prefix, p, s):
        """The JAX ``ResNet50`` (``conv1``, ``bn1``, ``layer{s}_{b}``) in the
        torchvision / timm names."""
        self.conv(prefix + "conv1", _get(p, "conv1"))
        self.norm(prefix + "bn1", _get(p, "bn1"), _get(s, "bn1"))
        tree = p if p else s
        for name in sorted((k for k in tree if k.startswith("layer")),
                           key=lambda k: tuple(int(v) for v in k[len("layer"):].split("_"))):
            si, bi = name[len("layer"):].split("_")
            base = f"{prefix}layer{si}.{bi}."
            bp, bs = _get(p, name), _get(s, name)
            for i in (1, 2, 3):
                self.conv(f"{base}conv{i}", _get(bp, f"conv{i}"))
                self.norm(f"{base}bn{i}", _get(bp, f"bn{i}"), _get(bs, f"bn{i}"))
            self.conv(f"{base}downsample.0", _get(bp, "downsample_conv"))
            self.norm(f"{base}downsample.1", _get(bp, "downsample_bn"), _get(bs, "downsample_bn"))

    def swin(self, prefix, p, s, cfg):
        """The JAX ``SwinTransformer`` (``patch_embed`` / ``patch_norm``,
        ``downsample{s}``, ``layers{s}_blocks{b}``, ``norm``) in timm's
        names; ``cfg`` is its ``SwinConfig`` (either package's)."""
        if cfg.conv_stem:
            pe, ps = _get(p, "patch_embed"), _get(s, "patch_embed")
            for i, slot in enumerate((0, 3)):
                self.conv(f"{prefix}patch_embed.proj.{slot}", _get(pe, f"conv{i}"))
                self.norm(f"{prefix}patch_embed.proj.{slot + 1}", _get(pe, f"bn{i}"),
                          _get(ps, f"bn{i}"))
            self.conv(f"{prefix}patch_embed.proj.6", _get(pe, "proj"))
            self.norm(f"{prefix}patch_embed.norm", _get(pe, "norm"))
        else:
            self.conv(f"{prefix}patch_embed.proj", _get(p, "patch_embed"))
            self.norm(f"{prefix}patch_embed.norm", _get(p, "patch_norm"))
        qkv = "attn.qkv.qkv" if cfg.lora_rank > 0 else "attn.qkv"
        for si, depth in enumerate(cfg.depths):
            if si > 0:
                d = _get(p, f"downsample{si}")
                self.norm(f"{prefix}layers.{si}.downsample.norm", _get(d, "norm"))
                self.conv(f"{prefix}layers.{si}.downsample.reduction", _get(d, "reduction"), _t)
            for bi in range(depth):
                b = _get(p, f"layers{si}_blocks{bi}")
                base = f"{prefix}layers.{si}.blocks.{bi}."
                self.norm(base + "norm1", _get(b, "norm1"))
                self.norm(base + "norm2", _get(b, "norm2"))
                self.conv(base + qkv, _get(b, "attn", "qkv"), _t)
                self.conv(base + "attn.proj", _get(b, "attn", "proj"), _t)
                self.put(base + "attn.relative_position_bias_table",
                         _get(b, "attn", "relative_position_bias_table"))
                for lq in ("lora_q", "lora_v"):
                    self.put(base + f"attn.qkv.{lq}.A", _get(b, "attn", lq, "A"))
                    self.put(base + f"attn.qkv.{lq}.B", _get(b, "attn", lq, "B"))
                self.conv(base + "mlp.fc1", _get(b, "mlp_fc1"), _t)
                self.conv(base + "mlp.fc2", _get(b, "mlp_fc2"), _t)
        self.norm(prefix + "norm", _get(p, "norm"))

    def wrapped_norm(self, key, p, s, name):
        """A JAX ``hemit._Norm`` (its BatchNorm one scope down, ``norm``)."""
        self.norm(key, _get(p, name, "norm"), _get(s, name, "norm"))

    def convnext(self, prefix, p):
        """The JAX ``ConvNeXt`` (``stem_conv``, ``stem_norm``,
        ``down{s}_*``, ``stage{s}_{b}``) in the FeatureListNet-flattened timm
        names."""
        self.conv(prefix + "stem.0", _get(p, "stem_conv"))
        self.norm(prefix + "stem.1", _get(p, "stem_norm"))
        for name in (p or {}):
            if name.startswith("down") and name.endswith("_norm"):
                self.norm(f"{prefix}stages_{name[4:-5]}.downsample.0", p[name])
            elif name.startswith("down") and name.endswith("_conv"):
                self.conv(f"{prefix}stages_{name[4:-5]}.downsample.1", p[name])
            elif name.startswith("stage"):
                si, bi = name[len("stage"):].split("_")
                base = f"{prefix}stages_{si}.blocks.{bi}."
                self.conv(base + "conv_dw", _get(p, name, "dwconv"))
                self.norm(base + "norm", _get(p, name, "norm"))
                self.conv(base + "mlp.fc1", _get(p, name, "pwconv1"), _t)
                self.conv(base + "mlp.fc2", _get(p, name, "pwconv2"), _t)
                self.put(base + "gamma", _get(p, name, "gamma"))


def _head_names(tree: Dict):
    return sorted((k for k in tree if k.startswith("segmentation_head_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))


def unetr_state_dict_from_jax(variables: Dict, vit_cfg: ViTConfig) -> Dict[str, np.ndarray]:
    """JAX ``UnetrViT`` variables (whole, or a sub-tree as in the module
    docstring) -> the port's ``unetr.UnetrViT`` state dict, the reference
    layout that ``unetr_from_torch`` reads."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    e = _Emitter()
    if params.get("encoder_vit"):
        e.out.update(_vit_state_dict(params["encoder_vit"], vit_cfg, "encoder.model."))
    fp, fs = params.get("feature_upsampler", {}), stats.get("feature_upsampler", {})
    fu = "encoder.feature_upsampler"
    for i in range(2):
        e.conv_block(f"{fu}.convsteam.{i}", _get(fp, f"convsteam_{i}"), _get(fs, f"convsteam_{i}"))
    for j, n_deconv in ((0, 3), (1, 2), (2, 1)):
        for d in range(n_deconv):
            e.deconv_block(f"{fu}.upsampler{j}.{d + 1}", _get(fp, f"upsampler{j}_{d}"),
                           _get(fs, f"upsampler{j}_{d}"))
    e.cellvit_decoder(params.get("decoder", {}), stats.get("decoder", {}))
    e.heads(params, stats, _head_names({**stats, **params}))
    return e.out


def unet_resnet50_state_dict_from_jax(variables: Dict) -> Dict[str, np.ndarray]:
    """JAX ``UnetResnet50`` variables -> the port's ``cnn.UnetResnet50``
    state dict (``encoder.model.*``, ``encoder.convsteam.*``, ``decoder.*``,
    the heads)."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    e = _Emitter()
    for i in range(2):
        e.conv_block(f"encoder.convsteam.{i}", _get(params, f"convsteam_{i}"),
                     _get(stats, f"convsteam_{i}"))
    e.resnet("encoder.model.", params.get("model", {}), stats.get("model", {}))
    e.cellvit_decoder(params.get("decoder", {}), stats.get("decoder", {}))
    e.heads(params, stats, _head_names({**stats, **params}))
    return e.out


def smp_unet_state_dict_from_jax(variables: Dict) -> Dict[str, np.ndarray]:
    """JAX ``UnetMultiHeads`` variables -> the port's
    ``smp_unet.UnetMultiHeads`` state dict: a ConvNeXt encoder (JAX
    ``stem_conv``) under ``encoder.model.``, a ResNet-50 under ``encoder.``;
    ``decoder.blocks.{i}.conv{1,2}.{0,1}``; the heads and
    ``foreground_head``."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    e = _Emitter()
    enc_p, enc_s = params.get("encoder", {}), stats.get("encoder", {})
    if "stem_conv" in enc_p:
        e.convnext("encoder.model.", enc_p)
    else:
        e.resnet("encoder.", enc_p, enc_s)
    tree = {**stats, **params}
    for name in (k for k in tree if k.startswith("decoder_block_")):
        i = name[len("decoder_block_"):]
        for conv in ("conv1", "conv2"):
            e.conv(f"decoder.blocks.{i}.{conv}.0", _get(params, name, conv, "conv"))
            e.norm(f"decoder.blocks.{i}.{conv}.1", _get(params, name, conv, "bn"),
                   _get(stats, name, conv, "bn"))
    e.heads(params, stats, _head_names(tree) + (["foreground_head"] if "foreground_head" in tree
                                                else []))
    return e.out


def swin_state_dict_from_jax(variables: Dict, cfg) -> Dict[str, np.ndarray]:
    """JAX ``SwinTransformer`` variables -> the port's ``swin.SwinTransformer``
    state dict (timm's names); ``cfg`` its ``SwinConfig``."""
    e = _Emitter()
    e.swin("", variables.get("params", {}), variables.get("batch_stats", {}), cfg)
    return e.out


def unetr_swin_state_dict_from_jax(variables: Dict, cfg) -> Dict[str, np.ndarray]:
    """JAX ``UnetrSwin`` variables (``model``, ``convsteam_{i}``,
    ``upsampler{j}_0``, ``decoder``, the heads) -> the port's
    ``unetr.UnetrSwin`` state dict; ``cfg`` is its ``SwinConfig``."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    e = _Emitter()
    e.swin("encoder.model.", params.get("model", {}), stats.get("model", {}), cfg)
    fu = "encoder.feature_upsampler"
    for i in range(2):
        e.conv_block(f"{fu}.convsteam.{i}", _get(params, f"convsteam_{i}"),
                     _get(stats, f"convsteam_{i}"))
    for j in range(4):
        e.deconv_block(f"{fu}.upsampler{j}", _get(params, f"upsampler{j}_0"),
                       _get(stats, f"upsampler{j}_0"))
    e.cellvit_decoder(params.get("decoder", {}), stats.get("decoder", {}))
    e.heads(params, stats, _head_names({**stats, **params}))
    return e.out


def _count(tree: Dict, prefix: str, suffix: str = "") -> int:
    return sum(1 for k in tree if k.startswith(prefix) and k.endswith(suffix)
               and k[len(prefix):len(k) - len(suffix)].isdigit())


def _hemit_swint(e: _Emitter, p: Dict, s: Dict, model) -> None:
    tree = {**s, **p}
    e.conv("initial_layers.1", _get(p, "initial_conv"))
    e.wrapped_norm("initial_layers.2", p, s, "initial_norm")
    for i in range(3):
        e.conv(f"downsampling_layers.{i}.0", _get(p, f"down{i}_conv"))
        e.wrapped_norm(f"downsampling_layers.{i}.1", p, s, f"down{i}_norm")
    for i in range(_count(tree, "res")):
        base = f"resnet_blocks.{i}.conv_block"
        e.conv(f"{base}.1", _get(p, f"res{i}", "conv1"))
        e.wrapped_norm(f"{base}.2", _get(p, f"res{i}"), _get(s, f"res{i}"), "n1")
        e.conv(f"{base}.5", _get(p, f"res{i}", "conv2"))
        e.wrapped_norm(f"{base}.6", _get(p, f"res{i}"), _get(s, f"res{i}"), "n2")
    e.swin("swinT.", _get(p, "swinT"), _get(s, "swinT"), model.swin_cfg)
    for i in range(3):
        g, base = _get(p, f"cross_att{i}"), f"cross_atts.{i}"
        e.conv(f"{base}.swinT_transform", _get(g, "swinT_transform"))
        qkv = [_get(g, f"attn_{n}") for n in "qkv"]
        if all(t is not None for t in qkv):
            e.put(f"{base}.attention.in_proj_weight",
                  np.concatenate([_t(t["kernel"]) for t in qkv]))
            e.put(f"{base}.attention.in_proj_bias", np.concatenate([t["bias"] for t in qkv]))
        e.conv(f"{base}.attention.out_proj", _get(g, "attn_out"), _t)
        e.conv(f"{base}.gate.0", _get(g, "gate"))
        for j in range(_count(g or {}, "up", "_deconv")):
            e.conv(f"{base}.upsample_blocks.{j}.0", _get(g, f"up{j}_deconv"), _convT)
            e.conv(f"{base}.upsample_blocks.{j}.2", _get(g, f"up{j}_conv"))
    for i in range(3):
        e.conv(f"upsampling_layers.{i}.0", _get(p, f"up{i}_deconv"), _convT)
        e.wrapped_norm(f"upsampling_layers.{i}.1", p, s, f"up{i}_norm")
    e.conv("final_layers.1", _get(p, "final_conv"))


def _resnet_generator(e: _Emitter, p: Dict, s: Dict, model) -> None:
    """pix2pix's ``model.{i}`` from the JAX names (``stem``, ``down{i}``,
    ``res{i}``, ``up{i}``, ``head``)."""
    e.conv("model.1", _get(p, "stem"))
    e.wrapped_norm("model.2", p, s, "stem_norm")
    for i, slot in enumerate((4, 7)):
        e.conv(f"model.{slot}", _get(p, f"down{i}"))
        e.wrapped_norm(f"model.{slot + 1}", p, s, f"down{i}_norm")
    n_blocks = sum(type(m).__name__ == "HemitResnetBlock" for m in model.model)
    for i in range(n_blocks):
        base = f"model.{10 + i}.conv_block"
        bp, bs = _get(p, f"res{i}"), _get(s, f"res{i}")
        e.conv(f"{base}.1", _get(bp, "conv1"))
        e.wrapped_norm(f"{base}.2", bp, bs, "n1")
        e.conv(f"{base}.5", _get(bp, "conv2"))
        e.wrapped_norm(f"{base}.6", bp, bs, "n2")
    up = 10 + n_blocks
    for i in range(2):
        e.conv(f"model.{up + 3 * i}", _get(p, f"up{i}"), _convT)
        e.wrapped_norm(f"model.{up + 3 * i + 1}", p, s, f"up{i}_norm")
    e.conv(f"model.{up + 7}", _get(p, "head"))


def _unet_generator(e: _Emitter, p: Dict, s: Dict, model) -> None:
    for i in range(model.num_downs):
        e.conv(f"down{i}", _get(p, f"down{i}"))
        e.wrapped_norm(f"down{i}_norm", p, s, f"down{i}_norm")
    for i in range(model.num_downs - 1):
        e.conv(f"up{i}", _get(p, f"up{i}"), _convT)
        e.wrapped_norm(f"up{i}_norm", p, s, f"up{i}_norm")
    e.conv("up_final", _get(p, "up_final"), _convT)


def _hybrid_swint(e: _Emitter, p: Dict, s: Dict, model) -> None:
    for i in range(len(model.cnn_block) // 4):
        e.conv(f"cnn_block.{4 * i}", _get(p, f"cnn{i}", "conv"))
        e.norm(f"cnn_block.{4 * i + 1}", _get(p, f"cnn{i}", "bn"), _get(s, f"cnn{i}", "bn"))
    e.swin("model.", _get(p, "swinT"), _get(s, "swinT"), model.model.cfg)
    for name in dict(model.decoder.named_children()):
        if name.startswith("upsample_and_conv"):
            e.conv(f"decoder.{name}.1", _get(p, name, "conv"))
        elif name.startswith("conv") or name.startswith("upsample"):
            e.conv(f"decoder.{name}", _get(p, name),
                   _convT if name.startswith("upsample") else _conv)
    for i in range(len(getattr(model.decoder, "final_upsample_layers", ()))):
        e.conv(f"decoder.final_upsample_layers.{i}", _get(p, f"final_up{i}"), _convT)


def _swin_unet(e: _Emitter, p: Dict, s: Dict, model) -> None:
    for i in range(model.num_downs):
        e.conv(f"down_layers.{i}.0", _get(p, f"down{i}"))
        e.norm(f"down_layers.{i}.2", _get(p, f"down{i}_norm"), _get(s, f"down{i}_norm"))
    e.swin("swinT.", _get(p, "swinT"), _get(s, "swinT"), model.swinT.cfg)
    for j in range(3):
        g, base = _get(p, f"cross_att{j}"), f"cross_atts.{j}"
        t, tb = _get(g, "transformer_unet"), f"{base}.transformer_unet.layers.0"
        e.conv(f"{base}.gate.0", _get(g, "gate"))
        e.norm(f"{base}.norm_swinT", _get(g, "norm_swinT"))
        e.conv(f"{base}.linear_swinT", _get(g, "linear_swinT"), _t)
        e.norm(f"{tb}.0.norm", _get(t, "attn_norm"))
        e.conv(f"{tb}.0.fn.to_qkv", _get(t, "to_qkv"), _t)
        e.conv(f"{tb}.0.fn.to_out.0", _get(t, "to_out"), _t)
        e.norm(f"{tb}.1.norm", _get(t, "ff_norm"))
        e.conv(f"{tb}.1.fn.net.0", _get(t, "ff_fc1"), _t)
        e.conv(f"{tb}.1.fn.net.3", _get(t, "ff_fc2"), _t)
    for i in range(model.num_downs - 1):
        e.conv(f"up_layers.{i}.0", _get(p, f"up{i}"), _convT)
        e.norm(f"up_layers.{i}.2", _get(p, f"up{i}_norm"), _get(s, f"up{i}_norm"))
    e.conv("final_layer.0", _get(p, "up_final"), _convT)


def _nlayer_discriminator(e: _Emitter, p: Dict, s: Dict, model) -> None:
    convs = [i for i, m in enumerate(model.model) if isinstance(m, torch.nn.Conv2d)]
    names = [f"conv{i}" for i in range(len(convs) - 1)] + ["conv_out"]
    for slot, name in zip(convs, names):
        e.conv(f"model.{slot}", _get(p, name))
    for i, slot in enumerate(convs[1:-1], 1):
        name = f"norm{i}" if i < len(convs) - 2 else "norm_last"
        e.wrapped_norm(f"model.{slot + 1}", p, s, name)


def _pixel_discriminator(e: _Emitter, p: Dict, s: Dict, model) -> None:
    e.conv("net.0", _get(p, "conv0"))
    e.conv("net.2", _get(p, "conv1"))
    e.wrapped_norm("net.3", p, s, "norm1")
    e.conv("net.5", _get(p, "conv_out"))


_HEMIT_MAPS = {"ResnetGeneratorSwinT": _hemit_swint, "ResnetGenerator": _resnet_generator,
               "UnetGenerator": _unet_generator, "HybridSwinT": _hybrid_swint,
               "HybridSwinT_2": _hybrid_swint, "SwinUnetGenerator": _swin_unet,
               "NLayerDiscriminator": _nlayer_discriminator,
               "PixelDiscriminator": _pixel_discriminator}


def hemit_state_dict_from_jax(variables: Dict, model) -> Dict[str, np.ndarray]:
    """JAX variables of a HEMIT-zoo module (``hemit.py``: the dual-branch
    generator, the pix2pix generators and discriminators;
    ``hemit_hybrid.py``: the three hybrids), whole or a sub-tree -> the
    state dict of ``model``, the port's module of the same class (its
    structure: block counts, the Swin's ``SwinConfig``)."""
    e = _Emitter()
    _HEMIT_MAPS[type(model).__name__](e, variables.get("params", {}),
                                      variables.get("batch_stats", {}), model)
    return e.out


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
