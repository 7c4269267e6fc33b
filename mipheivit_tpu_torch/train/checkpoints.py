"""Checkpoints: resumable train-state snapshots and the reference-format
export of a trained generator.

Counterpart of ``mipheivit_tpu/train/checkpoints.py``. Two formats:

  * **snapshots** -- the whole train state for mid-training resume, one
    ``torch.save`` file per step (``state_<step>.pt``; the JAX package
    writes orbax directories): the generator's parameters and buffers
    (the frozen encoder too, as orbax keeps it), the discriminator's, both
    ``AdamChain`` states, the step and the state's ``torch.Generator``.
    Restoring one continues training bit for bit.
  * **safetensors exchange** -- the generator's state dict under the
reference torch key names (``encoder.vit.*`` with the LoRA wrapper's
``attn.qkv.qkv`` / ``attn.qkv.lora_q.A`` ..., ``decoder.*`` with per-marker
``segmentation_head_{k}``), which is the port's own module layout, in f32,
optionally with the frozen foundation encoder stripped so that only LoRA and
the decoder ship (reference: scripts/ckpt_remove_foundation_model.py:7-22).
It loads with the JAX package's ``mipheivit_from_torch`` / ``load_generator``
and with the port's ``infer.load_generator``. The baseline generators export
their own module layout the same way, which is the reference's too (the UNETR
under ``encoder.model.*``, which ``unetr_from_torch`` reads); the JAX trainer
writes those in a flattened flax layout instead (trainer.py:419-427).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..io.safetensors import save_file
from ..models.vit import VisionTransformer


def generator_state_dict(model: torch.nn.Module,
                         strip_foundation: bool = False) -> Dict[str, np.ndarray]:
    """Reference-layout state dict of numpy arrays (floating values as f32);
    ``strip_foundation`` leaves out the foundation ViT but its LoRA
    adapters."""
    if getattr(model.decoder, "fast_heads", False):
        raise ValueError("export takes the per-head decoder (fast_heads=False), "
                         "the reference layout")
    # the foundation ViT's own names (``encoder.vit.``, ``encoder.model.``)
    vit_prefixes = tuple(f"{n}." for n, m in model.named_modules()
                         if isinstance(m, VisionTransformer))
    out = {}
    for name, value in model.state_dict().items():
        if strip_foundation and name.startswith(vit_prefixes) and ".lora_" not in name:
            continue
        value = value.detach().cpu()
        out[name] = (value.float() if value.is_floating_point() else value).numpy()
    return out


def save_generator(model: torch.nn.Module, path, strip_foundation: bool = False) -> None:
    """Write ``generator_state_dict`` as a safetensors file (``model.safetensors``
    in a checkpoint dir)."""
    save_file(generator_state_dict(model, strip_foundation), path)


# ---------------------------------------------------------------------------
# train-state snapshots


def _opt_state_dict(opt) -> Optional[Dict]:
    """An ``OptState``'s fields; its tensor sequences (lists, or the tuples
    ``torch._foreach_*`` returns) as lists."""
    if opt is None:
        return None
    out = {}
    for f in dataclasses.fields(opt):
        value = getattr(opt, f.name)
        out[f.name] = list(value) if isinstance(value, (list, tuple)) else value
    return out


def _snapshot_step(path: Path) -> Optional[int]:
    stem = path.name[len("state_"):-len(".pt")]
    return int(stem) if path.name.startswith("state_") and stem.isdigit() else None


def save_train_state(state, ckpt_dir, step: Optional[int] = None, keep_last: int = 2) -> str:
    """Write ``state`` (a ``train.steps.TrainState``) to
    ``<ckpt_dir>/state_<step>.pt`` (through a temporary file, so a
    snapshot on disk is whole) and prune all but the newest ``keep_last``
    snapshots: each holds the frozen 1.1B-parameter encoder (~2.3 GB in
    bf16 at flagship scale). ``keep_last=0`` keeps everything."""
    path = Path(ckpt_dir).absolute()
    path.mkdir(parents=True, exist_ok=True)
    step = int(state.step) if step is None else int(step)
    target = path / f"state_{step}.pt"
    snap = {
        "step": int(state.step),
        "generator": state.generator.state_dict(),
        "gen_opt_state": _opt_state_dict(state.gen_opt_state),
        "disc": state.disc.state_dict() if state.disc is not None else None,
        "disc_opt_state": _opt_state_dict(state.disc_opt_state),
        "rng": state.rng.get_state() if state.rng is not None else None,
    }
    tmp = target.with_name(target.name + ".tmp")
    torch.save(snap, tmp)
    os.replace(tmp, target)
    if keep_last:
        snaps = sorted((p for p in path.glob("state_*.pt") if _snapshot_step(p) is not None),
                       key=_snapshot_step)
        for old in snaps[:-keep_last]:
            old.unlink(missing_ok=True)
    return str(target)


def _restore_opt(opt, saved: Optional[Dict], device) -> None:
    if (opt is None) != (saved is None):
        raise ValueError("the snapshot and the train state disagree on a discriminator")
    if opt is None:
        return
    for name, value in saved.items():
        if isinstance(value, (list, tuple)):
            value = [t.to(device) if torch.is_tensor(t) else t for t in value]
        setattr(opt, name, value)


def restore_train_state(ckpt_path, state):
    """Load a ``save_train_state`` snapshot into ``state`` (built by
    ``create_train_state`` for the same model and optimizers) in place and
    return it."""
    snap = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state.generator.load_state_dict(snap["generator"])
    if state.disc is not None:
        state.disc.load_state_dict(snap["disc"])
    _restore_opt(state.gen_opt_state, snap["gen_opt_state"], state.device)
    _restore_opt(state.disc_opt_state, snap["disc_opt_state"], state.device)
    if state.rng is not None and snap["rng"] is not None:
        state.rng.set_state(snap["rng"])
    state.step = int(snap["step"])
    return state


def latest_checkpoint(ckpt_dir) -> Optional[str]:
    """The snapshot of the highest step in ``ckpt_dir``, or None."""
    path = Path(ckpt_dir)
    if not path.is_dir():
        return None
    steps = [(s, p) for p in path.glob("state_*.pt") if (s := _snapshot_step(p)) is not None]
    return str(max(steps)[1]) if steps else None
