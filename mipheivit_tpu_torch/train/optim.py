"""Optimizers, trainability and layer-wise LR decay (PyTorch).

Counterpart of ``mipheivit_tpu/train/optim.py``, whose recipe is the
reference's (src/models.py:348-387): the optax chain

    clip_by_global_norm(1.0) -> scale_by_adam(0.5, 0.999, eps 1e-7)
    -> scale_by_schedule(pix2pix) -> scale(-lr)

wrapped in ``optax.MultiSteps`` when gradients are accumulated. Each step of
the chain is written out here with optax's arithmetic: the clip is
``g`` below the norm and ``(g / norm) * 1.0`` above it (no epsilon), the
Adam moments are ``(1 - b) * g + b * m`` with bias correction by the
post-increment count, the schedule is read at the count before its
increment (so the first update is zero), and accumulation keeps the running
mean ``acc + (g - acc) / (n + 1)`` of k microbatch gradients and emits one
update every k calls.

Trainability is ``requires_grad``: the frozen foundation encoder has no
gradients and no Adam moments (the JAX package's ``partition_params``), so
the JAX chain's ``masked_updates`` has nothing to mask. The rule is the JAX
package's ``is_trainable``, applied to each parameter's JAX module path
(``jax_path``), so the port trains exactly the tensors the JAX package does.
That includes its quirk: ``unet_lora`` and ``unet_frozen`` freeze nothing,
because the JAX ``UnetrViT`` and ``UnetrSwin`` have no module named
``encoder`` (ROADMAP.md queue 3).

Over a tensor-parallel generator the clip's global norm sums the squares of
the sharded tensors over the model group (``AdamChain.step``), as the JAX
chain's norm over the global arrays does.

The generator's chain takes the layer-wise LR decay of fully trainable
``unet`` encoders (``layer_decay_multiplier``) between the clip and Adam,
as the JAX chain does (mipheivit_tpu/train/optim.py:117-128).
The chain runs as multi-tensor ``torch._foreach_*`` ops over all trainable
tensors at once (a few hundred: per-tensor ops cost ~0.1 s of launches per
step on an H100), updating the moments and the parameters in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.vit import VisionTransformer
from .schedule import pix2pix_schedule


def is_trainable(name: str, model_name: str) -> bool:
    """The JAX package's rule on a dotted JAX module path (``jax_path``):
    myvitmatte (and LoRA models): the encoder is frozen except its LoRA
    adapters and any feature upsampler; the decoder trains. ``frozen``
    models: the encoder is frozen except the feature upsampler. Others: all
    trainable."""
    if model_name.startswith("myvitmatte") or "lora" in model_name:
        if name.startswith("encoder."):
            return "lora_q" in name or "lora_v" in name or "feature_upsampler" in name
        return True
    if "frozen" in model_name:
        return not name.startswith("encoder.") or "feature_upsampler" in name
    return True


def jax_path(model: torch.nn.Module, name: str) -> str:
    """A parameter's name with its top-level scope renamed to the JAX
    module's (the model's ``JAX_SCOPES``; ``UnetrViT``'s
    ``encoder.model.`` is the JAX ``encoder_vit``, ``UnetrSwin``'s the JAX
    ``model``, for two). The flagship's, the SMP U-Net's and the HEMIT
    generators' scopes are the JAX ones already (none is ``encoder``)."""
    for port, jax in getattr(model, "JAX_SCOPES", {}).items():
        if name.startswith(port):
            return jax + name[len(port):]
    return name


def layer_decay_multiplier(model: torch.nn.Module, name: str, lr_decay_rate: float = 0.65,
                           num_layers: int = 40) -> float:
    """The JAX ``layer_decay_multiplier`` (mipheivit_tpu/train/optim.py:58-69)
    of the parameter ``name`` of ``model``, in f32: ``rate^(L + 1)`` for the
    position and patch embeddings and the cls / register tokens,
    ``rate^(L - i)`` for ViT block i, 1 otherwise. L is ``num_layers``
    whatever the encoder's depth (the JAX trainer passes 40, univ2 has 24
    blocks)."""
    for vit_name, vit in model.named_modules():
        if not isinstance(vit, VisionTransformer):
            continue
        prefix = f"{vit_name}." if vit_name else ""
        if not name.startswith(prefix):
            continue
        rest = name[len(prefix):]
        if rest.startswith("blocks."):
            i = int(rest.split(".")[1])
            return float(np.float32(lr_decay_rate) ** np.float32(num_layers - i))
    if any(t in name for t in ("pos_embed", "patch_embed", "cls_token", "reg_token")):
        return float(np.float32(lr_decay_rate ** (num_layers + 1)))
    return 1.0


def set_trainable(model: torch.nn.Module, model_name: str,
                  frozen_dtype: Optional[torch.dtype] = None) -> List[Tuple[str, torch.nn.Parameter]]:
    """Mark each parameter trainable or frozen by ``is_trainable`` on its
    ``jax_path``; store the frozen floating ones in ``frozen_dtype`` when
    given (they never update, and the forward casts them to the compute
    dtype anyway). Returns the trainable ``(name, parameter)`` pairs."""
    trainable = []
    for name, p in model.named_parameters():
        keep = is_trainable(jax_path(model, name), model_name)
        p.requires_grad_(keep)
        if keep:
            trainable.append((name, p))
        elif frozen_dtype is not None and p.is_floating_point():
            p.data = p.data.to(frozen_dtype)
    return trainable


@dataclasses.dataclass
class OptState:
    """Everything the chain carries between calls (optax's nested states)."""

    adam_count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    schedule_count: int
    mini_step: int = 0                        # MultiSteps
    gradient_step: int = 0
    acc: Optional[List[torch.Tensor]] = None  # running mean of microbatch grads
    layer_scale: Optional[List[float]] = None  # the layer decay's multipliers


class AdamChain:
    """The chain of ``build_generator_optimizer`` /
    ``build_discriminator_optimizer``, applied in place. With
    ``layer_decay`` (rate, num_layers) the clipped gradients are scaled by
    the multipliers ``init`` was given, before Adam."""

    max_norm, b1, b2, eps = 1.0, 0.5, 0.999, 1e-7

    def __init__(self, lr: float, total_iters: int, warmup_iters: int = 400,
                 grad_accum_steps: int = 1, layer_decay: Optional[Tuple[float, int]] = None):
        self.lr = lr
        self.schedule = pix2pix_schedule(1.0, total_iters, warmup_iters)
        self.k = max(int(grad_accum_steps), 1)
        self.layer_decay = layer_decay

    def init(self, params: Sequence[torch.Tensor],
             layer_scale: Optional[Sequence[float]] = None) -> OptState:
        """Zero moments for ``params``; ``layer_scale`` holds one multiplier
        a tensor (``layer_decay_multiplier``), needed with ``layer_decay``."""
        if self.layer_decay is not None and layer_scale is None:
            raise ValueError("a chain with layer decay needs each tensor's multiplier")
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(adam_count=0, mu=zeros, nu=[z.clone() for z in zeros], schedule_count=0,
                        acc=[z.clone() for z in zeros] if self.k > 1 else None,
                        layer_scale=None if self.layer_decay is None else list(layer_scale))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: OptState, sharded: Optional[Sequence[bool]] = None, group=None) -> bool:
        """One call of the chain on this microbatch's gradients; updates
        ``params`` in place when an update is emitted (every call without
        accumulation, every k-th with it). Returns whether it was.

        ``sharded`` (a flag a tensor) and ``group``: the tensors of a
        tensor-parallel generator that are shards of a split weight, and its
        model group. The clip's global norm then sums their squares over the
        group and counts the replicated tensors once; without them, or with
        no flag set, the arithmetic is the one-process chain's."""
        grads = [g.float() for g in grads]
        if self.k > 1:
            n = state.mini_step
            delta = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(state.acc, delta)           # acc + (g - acc) / (n + 1)
            state.mini_step = (n + 1) % self.k
            if n != self.k - 1:
                return False
            grads, state.acc = state.acc, [torch.zeros_like(a) for a in state.acc]
            state.gradient_step += 1
        updates = self._inner(grads, state, sharded, group)
        if any(p.dtype != torch.float32 for p in params):
            updates = [u.to(p.dtype) for u, p in zip(updates, params)]
        torch._foreach_add_(list(params), updates)
        return True

    def _inner(self, grads: List[torch.Tensor], state: OptState, sharded=None,
               group=None) -> List[torch.Tensor]:
        # clip_by_global_norm: g below the norm, (g / norm) * max_norm above it
        norms = torch.stack(torch._foreach_norm(grads))
        if sharded is not None and any(sharded):
            split = torch.tensor(list(sharded), device=norms.device)
            squares = torch.stack([(norms[split] ** 2).sum(), (norms[~split] ** 2).sum()])
            # every rank of the group holds other shards of the split tensors
            shard_sq = squares[:1].clone()
            dist.all_reduce(shard_sq, group=group)
            norm = torch.sqrt(shard_sq[0] + squares[1])
        else:
            norm = torch.linalg.vector_norm(norms)
        scaled = torch._foreach_mul(torch._foreach_div(grads, norm), self.max_norm)
        below = norm < self.max_norm
        grads = [torch.where(below, g, s) for g, s in zip(grads, scaled)]
        if state.layer_scale is not None:
            torch._foreach_mul_(grads, state.layer_scale)
        # scale_by_adam: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, b2))
        state.mu, state.nu = mu, nu
        state.adam_count += 1
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(state.adam_count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(state.adam_count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(den, self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, c1), den)
        # scale_by_schedule, then scale(-lr)
        step_size = self.schedule(state.schedule_count)
        state.schedule_count += 1
        return torch._foreach_mul(torch._foreach_mul(updates, step_size), -self.lr)


def build_generator_optimizer(lr: float, total_iters: int, warmup_iters: int = 400,
                              grad_accum_steps: int = 1, vit_lr_decay: bool = False,
                              num_layers: int = 40) -> AdamChain:
    """The generator's chain; ``vit_lr_decay`` adds the 0.65 layer decay
    over ``num_layers`` (the JAX ``build_generator_optimizer``)."""
    return AdamChain(lr, total_iters, warmup_iters, grad_accum_steps,
                     layer_decay=(0.65, num_layers) if vit_lr_decay else None)


def build_discriminator_optimizer(lr: float, total_iters: int, warmup_iters: int = 400,
                                  grad_accum_steps: int = 1) -> AdamChain:
    return AdamChain(lr, total_iters, warmup_iters, grad_accum_steps)
