"""Reference checkpoints of the Swin models into the port: timm and
ctranspath Swin state dicts, and the HEMIT codebase's generators.

Counterpart of ``mipheivit_tpu/models/import_hemit.py`` and the Swin part
of ``mipheivit_tpu/models/import_weights.py`` (:466-595). The port's
modules carry the reference names (``models.swin``, ``models.hemit``,
``models.hemit_hybrid``), so where the JAX importers build a flax tree,
these are key maps: strip the Lightning / ``torch.compile`` prefixes, move
the older timm's end-of-stage downsample keys to the stage they feed
(``adapt_checkpoint_ctranspath``), drop the index and mask buffers, wrap qkv
in the LoRA layout where the model has adapters, bicubic-resample each
relative-position bias table onto the window its grid gives
(``resize_rel_pos_bias_table``), and drop the reference ``Cross_Att``'s
unused submodules. Each ``*_from_torch`` then loads the result into the
port's module strictly (only BatchNorm's ``num_batches_tracked`` may be
absent) and returns it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..infer.loading import load_strict
from .convert import generator_state_dict


def adapt_checkpoint_ctranspath(state: Dict) -> Dict:
    """Shift old-timm end-of-stage downsample keys to the stage they feed
    and drop the index / mask buffers (reference:
    foundation_models.py:370-383); keys without a prefix."""
    out = {}
    for k, v in state.items():
        if ".downsample.norm" in k or "downsample.reduction" in k:
            parts = k.split(".")
            parts[1] = str(int(parts[1]) + 1)
            k = ".".join(parts)
        elif "relative_position_index" in k or "attn_mask" in k:
            continue
        out[k] = v
    return out


def resize_rel_pos_bias_table(table, new_window: int) -> torch.Tensor:
    """timm's ``resize_rel_pos_bias_table`` role: resample the
    ``[(2w-1)^2, heads]`` table bicubically (antialiased, in f64) onto
    ``2 * new_window - 1`` per side; unchanged when the size already fits."""
    table = torch.as_tensor(np.asarray(table) if not torch.is_tensor(table) else table)
    n, heads = table.shape
    old, new = int(round(n ** 0.5)), 2 * new_window - 1
    if old == new:
        return table
    grid = table.double().reshape(old, old, heads).permute(2, 0, 1)[None]
    grid = F.interpolate(grid, size=(new, new), mode="bicubic", align_corners=False,
                         antialias=True)
    return grid[0].permute(1, 2, 0).reshape(new * new, heads).to(table.dtype)


def swin_state_dict_from_timm(state: Dict, cfg, prefix: str = "") -> Dict:
    """A timm-layout (newer, downsample-first) Swin under ``prefix`` in
    ``state`` -> the same keys for the port's ``swin.SwinTransformer`` built
    from ``cfg``: buffers dropped, qkv wrapped for LoRA (the adapters stay
    at their init unless ``state`` holds them), bias tables resampled to each
    stage's window. Keys outside ``prefix`` pass through."""
    out = {}
    for k, v in state.items():
        if not k.startswith(prefix):
            out[k] = v
            continue
        rest = k[len(prefix):]
        if "relative_position_index" in rest or "attn_mask" in rest:
            continue
        if cfg.lora_rank > 0 and (rest.endswith("attn.qkv.weight") or
                                  rest.endswith("attn.qkv.bias")):
            rest = rest.replace("attn.qkv.", "attn.qkv.qkv.")
        if rest.endswith("relative_position_bias_table"):
            si = int(rest.split(".")[1])
            v = resize_rel_pos_bias_table(v, min(cfg.window_size, *cfg.stage_grid(si)))
        out[prefix + rest] = v
    return out


def _swin_part(state: Dict, prefix: str, cfg, old_timm_layout: bool = False) -> Dict:
    if old_timm_layout:
        sub = adapt_checkpoint_ctranspath({k[len(prefix):]: v for k, v in state.items()
                                           if k.startswith(prefix)})
        state = {**{k: v for k, v in state.items() if not k.startswith(prefix)},
                 **{prefix + k: v for k, v in sub.items()}}
    return swin_state_dict_from_timm(state, cfg, prefix)


def hemit_swint_from_torch(state: Dict, model, old_timm_layout: bool = False):
    """A HEMIT-codebase ``ResnetGeneratorSwinT`` state dict into ``model``
    (``models.hemit.ResnetGeneratorSwinT``); ``old_timm_layout`` for a Swin
    branch saved by a timm with end-of-stage downsamples."""
    state = _swin_part(generator_state_dict(state), "swinT.", model.swin_cfg, old_timm_layout)
    return load_strict(model, state)


def hybrid_swint_from_torch(state: Dict, model):
    """A HEMIT-codebase ``HybridSwinT`` state dict into ``model``
    (``models.hemit_hybrid.HybridSwinT``; its Swin is ``model.*``)."""
    return load_strict(model, _swin_part(generator_state_dict(state), "model.", model.model.cfg))


def hybrid_swint2_from_torch(state: Dict, model):
    """A HEMIT-codebase ``HybridSwinT_2`` state dict into ``model``."""
    return load_strict(model, _swin_part(generator_state_dict(state), "model.", model.model.cfg))


_UNUSED_CROSS_ATT = (".transformer_swinT.", ".norm_unet.", ".linear_unet.")


def swin_unet_from_torch(state: Dict, model):
    """A HEMIT-codebase ``SwinUnetGenerator`` state dict into ``model``; the
    reference ``Cross_Att``'s unused submodules (``transformer_swinT``,
    ``norm_unet``, ``linear_unet``) are dropped."""
    state = {k: v for k, v in generator_state_dict(state).items()
             if not (k.startswith("cross_atts.") and any(u in k for u in _UNUSED_CROSS_ATT))}
    return load_strict(model, _swin_part(state, "swinT.", model.swinT.cfg))


IMPORTERS = {"SwinTResnet": hemit_swint_from_torch, "swinT": hybrid_swint_from_torch,
             "swinT_old": hybrid_swint2_from_torch, "SwinTUnet": swin_unet_from_torch}
