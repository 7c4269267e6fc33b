"""LR schedules and layer-wise decay (reference: src/utils.py:217-306).

Counterpart of ``mipheivit_tpu/train/schedule.py``; the schedule is a plain
function of the optimizer-step count, evaluated in f32 as the JAX package
evaluates it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def pix2pix_schedule(base_lr: float, total_iters: int, warmup_iters: int = 400,
                     decay_start_iter: int | None = None) -> Callable[[int], float]:
    """Linear warmup -> constant -> linear decay to 0 from total/2
    (reference: src/utils.py:217-230, wired at src/models.py:363-371)."""
    if decay_start_iter is None:
        decay_start_iter = total_iters // 2
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_iters:
            factor = step / f32(max(warmup_iters, 1))
        elif step < decay_start_iter:
            factor = f32(1.0)
        else:
            decay_steps = f32(max(total_iters - decay_start_iter, 1))
            factor = max(f32(0.0), f32(1.0) - (step - f32(decay_start_iter)) / decay_steps)
        return float(f32(base_lr) * f32(factor))

    return schedule


def scaled_lr(base_lr: float, batch_size: int) -> float:
    """sqrt-batch LR scaling (reference: src/train.py:163-164)."""
    return base_lr * float(np.sqrt(batch_size))


def vit_layer_decay_rate(name: str, lr_decay_rate: float = 0.65,
                         num_layers: int = 12) -> float:
    """Layer-wise LR decay multiplier for fully-trainable ViT encoders
    (reference: src/utils.py:289-306). ``name`` is a parameter path ('/' or
    '.' separated); patch/pos embed get layer 0, block i gets layer i+1, the
    rest num_layers+1."""
    layer_id = num_layers + 1
    if "encoder" in name:
        if "pos_embed" in name or "patch_embed" in name:
            layer_id = 0
        else:
            for sep in ("blocks_", "blocks."):
                if sep in name:
                    layer_id = int(name.split(sep)[1].replace("/", ".").split(".")[0]) + 1
                    break
    return lr_decay_rate ** (num_layers + 1 - layer_id)
