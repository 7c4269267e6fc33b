"""Export of a trained generator in the reference checkpoint format.

Counterpart of the safetensors-exchange half of
``mipheivit_tpu/train/checkpoints.py``: the generator's state dict under the
reference torch key names (``encoder.vit.*`` with the LoRA wrapper's
``attn.qkv.qkv`` / ``attn.qkv.lora_q.A`` ..., ``decoder.*`` with per-marker
``segmentation_head_{k}``), which is the port's own module layout, in f32,
optionally with the frozen foundation encoder stripped so that only LoRA and
the decoder ship (reference: scripts/ckpt_remove_foundation_model.py:7-22).
It loads with the JAX package's ``mipheivit_from_torch`` / ``load_generator``
and with the port's ``infer.load_generator``. Resumable full-state snapshots
come with the trainer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..io.safetensors import save_file


def generator_state_dict(model: torch.nn.Module,
                         strip_foundation: bool = False) -> Dict[str, np.ndarray]:
    """Reference-layout state dict of numpy arrays (floating values as f32)."""
    if getattr(model.decoder, "fast_heads", False):
        raise ValueError("export takes the per-head decoder (fast_heads=False), "
                         "the reference layout")
    out = {}
    for name, value in model.state_dict().items():
        if strip_foundation and name.startswith("encoder.vit.") and ".lora_" not in name:
            continue
        value = value.detach().cpu()
        out[name] = (value.float() if value.is_floating_point() else value).numpy()
    return out


def save_generator(model: torch.nn.Module, path, strip_foundation: bool = False) -> None:
    """Write ``generator_state_dict`` as a safetensors file (``model.safetensors``
    in a checkpoint dir)."""
    save_file(generator_state_dict(model, strip_foundation), path)
