"""Train / eval / predict steps (PyTorch).

Counterpart of ``mipheivit_tpu/train/steps.py``, a functional rebuild of the
reference Lightning module's manual dual-optimizer GAN loop (reference:
src/models.py:87-205): generator step (reconstruction + optional
adversarial term, global-norm clip 1.0, per-step LR schedule), then the
discriminator step on detached fakes with 0.05 label noise, the streaming
pixel metrics and the NaN flag.

One ``train_step`` call is one microbatch, as in the JAX package: with
gradient accumulation the optimizer emits an update every k calls, while
BatchNorm statistics and the discriminator's power iteration and label
noise advance on every call. Where the JAX step returns a new state, this
one updates the modules and optimizer states in place and returns the same
``TrainState``. Gradients are taken with ``torch.autograd.grad`` for the
trainable parameters alone (frozen weights get none), so the generator's
backward never touches the discriminator's gradients and vice versa.

The reference's inverted GAN labels are kept: the discriminator is trained
toward fake = 1 / real = 0 and the generator minimizes BCE(D(fake), 0)
(reference: src/models.py:109,158-165). Label noise is drawn from the
state's ``torch.Generator``.

Everything runs on the card unless the caller passes ``device="cpu"``;
without a card and without that, ``create_train_state`` raises.

Over several ranks (``create_train_state(..., mesh=...)``), each rank takes
its own rows of the global batch: the BatchNorm statistics are those of the
global batch (``layers.sync_batch_norm`` over the data group), and every
microbatch's gradients are averaged over the data group and summed over
the model group before the optimizer sees them. With a sequence-sharded
ViT one bucketed ``all_reduce`` over every rank does both: the gradients of
the ViT's parameters, partial sums over the rank's token shard
(``parallel/seq.py``), are multiplied by the model group's size first; the
others (the decoder's, the same on every rank of a model group) are not.

A tensor-parallel generator (``parallel.sharding.shard_params`` before
``create_train_state``) cannot take that one collective: one rank's shard
gradient must never be added to another rank's shard. Its rule:

- the gradients of the sharded tensors (the qkv, proj, fc1 and fc2 weights
  and the qkv and fc1 biases; a Swin block's qkv and proj) are averaged
  over the data group only;
- those of the replicated tensors inside a column branch (the live LoRA A
  and B, and a Swin block's relative-position table: each rank's are
  partial sums over its heads, a table's nonzero only in its heads'
  columns) are summed over the model group, then averaged over the data
  group;
- all other gradients (a Swin block's MLP, the norms, the patch merging and
  the decoder among them), the same on every rank of a model group in exact
  arithmetic, are averaged over every rank: on the card a non-deterministic
  kernel (cuDNN's weight gradients of the decoder) leaves them a few bits
  apart between the ranks of a model group, and the replicated tensors
  would drift apart.

The optimizer's clip then takes the squares of the sharded tensors summed
over the model group (``AdamChain.step``), the replicated ones once.

``DistributedDataParallel`` cannot do this here: its reducer fires on
``.grad`` hooks, which ``torch.autograd.grad`` bypasses. The
discriminator's gradients are averaged over every rank. Dropout and the
label noise draw from the state's ``rng``, seeded by (seed, data rank), so
that the ranks of one model group draw alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .._device import resolve_device
from ..metrics.pixel import PixelMetrics
from ..models.layers import sync_batch_norm, use_generator
from ..models.vit import VisionTransformer
from ..parallel.mesh import Mesh, average_gradients
from ..parallel.sharding import param_layouts, partial_params
from .losses import adversarial_loss, focal_bce_loss
from .optim import AdamChain, OptState, layer_decay_multiplier, set_trainable


@dataclasses.dataclass
class TrainState:
    step: int                                        # microbatches taken
    generator: torch.nn.Module
    gen_params: List[Tuple[str, torch.nn.Parameter]]  # the trainable ones, by name
    gen_opt_state: OptState
    disc: Optional[torch.nn.Module] = None
    disc_opt_state: Optional[OptState] = None
    rng: Optional[torch.Generator] = None
    device: torch.device = torch.device("cpu")
    mesh: Optional[Mesh] = None                       # the ranks' layout (None: one process)
    grad_scales: Optional[List[float]] = None         # per trainable parameter, before the mean
    tp: Optional["TensorParallelGrads"] = None         # a tensor-parallel generator's rule


@dataclasses.dataclass(frozen=True)
class TensorParallelGrads:
    """Per trainable tensor of a tensor-parallel generator: a shard of a
    split weight (``sharded``), or replicated in a column branch with a
    partial gradient (``partial``: the LoRA adapters, the Swin bias
    tables)."""

    sharded: Tuple[bool, ...]
    partial: Tuple[bool, ...]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX ``StepConfig`` without ``freeze_model_name`` (the trainable
    partition is the state's, ``create_train_state``) and
    ``cell_capacity`` (the port's pooling needs none). With
    ``foreground_head`` the generator returns ``(masks, fg_logits)``."""

    gan_train: bool = False
    lsgan: bool = False
    foreground_head: bool = False
    use_cell_loss: bool = False
    data_range: tuple = (-0.9, 0.9)


def create_train_state(model: torch.nn.Module, gen_optimizer: AdamChain, disc=None,
                       disc_optimizer: Optional[AdamChain] = None,
                       freeze_model_name: Optional[str] = None,
                       frozen_dtype: Optional[torch.dtype] = None, seed: int = 0,
                       device=None, grad_checkpointing: bool = False,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Move the generator (and discriminator) to ``device`` in training mode,
    mark the trainable parameters (``freeze_model_name``, the JAX package's
    ``optim.is_trainable`` rule; None: all of them), store the frozen
    ones in ``frozen_dtype`` when given (the JAX package's ``frozen_dtype``:
    bit-identical in the step, half the memory in bf16), and initialise the
    optimizer states for the trainable parameters only (with the layer
    decay's multipliers when the chain has one).
    ``grad_checkpointing`` recomputes each ViT block in the backward. The
    state's ``rng`` drives the label noise and, in the step, every
    ``Dropout``. With a ``mesh`` of several ranks the BatchNorms are synced
    over its data group, the rng is seeded by (seed, data rank) and the step
    reduces the gradients over every rank (the module docstring). A
    tensor-parallel generator needs the mesh it was sharded over."""
    device = resolve_device(device)
    layouts = param_layouts(model)
    if layouts and (mesh is None or mesh.n_model == 1):
        raise ValueError("a tensor-parallel generator trains over the mesh it was sharded over")
    model.to(device).train()
    gen_params = set_trainable(model, freeze_model_name or "", frozen_dtype)
    for m in model.modules():
        if isinstance(m, VisionTransformer):
            m.grad_checkpointing = grad_checkpointing
    scale = None
    if gen_optimizer.layer_decay is not None:
        rate, n_layers = gen_optimizer.layer_decay
        scale = [layer_decay_multiplier(model, n, rate, n_layers) for n, _ in gen_params]
    grad_scales = tp = None
    if mesh is not None and mesh.size > 1:
        sync_batch_norm(model, mesh.data_group)
        if layouts:
            partial = set(partial_params(model))
            tp = TensorParallelGrads(tuple(n in layouts for n, _ in gen_params),
                                     tuple(n in partial for n, _ in gen_params))
        else:
            sharded = {id(p) for m in model.modules()
                       if isinstance(m, VisionTransformer) and m.cfg.attn_impl == "seq_shard"
                       for p in m.parameters()}
            grad_scales = [float(mesh.n_model) if id(p) in sharded else 1.0
                           for _, p in gen_params]
        # rank 0 draws as one process does; the ranks of a model group alike
        seed = seed + 1_000_003 * mesh.data_rank
    state = TrainState(step=0, generator=model, gen_params=gen_params,
                       gen_opt_state=gen_optimizer.init([p for _, p in gen_params], scale),
                       rng=torch.Generator(device=device).manual_seed(seed), device=device,
                       mesh=mesh if mesh is not None and mesh.size > 1 else None,
                       grad_scales=grad_scales, tp=tp)
    if disc is not None:
        disc.to(device).train()
        state.disc = disc
        state.disc_opt_state = disc_optimizer.init(list(disc.parameters()))
    return state


def _label_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """U[0, 1) draws for the discriminator's label noise."""
    return torch.rand(shape, generator=generator, device=generator.device)


def _on_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _reduce_tensor_parallel(grads, state: TrainState) -> None:
    """The tensor-parallel rule of the module docstring, in place."""
    mesh, tp = state.mesh, state.tp
    partial = [g for g, p in zip(grads, tp.partial) if p]
    if partial:
        # the mean of n_model times each rank's share: the model group's sum
        average_gradients(partial, [float(mesh.n_model)] * len(partial), mesh.model_group)
    split = [g for g, s, p in zip(grads, tp.sharded, tp.partial) if s or p]
    if split and mesh.data_group is not None:
        average_gradients(split, group=mesh.data_group)
    average_gradients([g for g, s, p in zip(grads, tp.sharded, tp.partial) if not (s or p)])


def make_train_step(model, loss_reconstruct: Callable, gen_optimizer: AdamChain,
                    disc=None, disc_optimizer: Optional[AdamChain] = None,
                    cfg: StepConfig = StepConfig(), cell_loss_fn: Optional[Callable] = None):
    """The train step: ``(state, batch, metrics) -> (state, metrics, log)``.

    batch: ``{"image": [B, H, W, 3], "target": [B, H, W, C]}`` and, with
    the cell loss on, ``"nuclei": [B, H, W]`` (numpy or torch; moved to the
    state's device). With ``cfg.use_cell_loss`` and a ``cell_loss_fn``,
    ``cell_loss_fn(fake, target, nuclei)`` joins the generator loss. ``log``
    holds the losses as 0-d tensors (the JAX step's keys), the NaN flag,
    and ``grads``: this microbatch's gradients of the trainable parameters
    by name (before clipping). With ``cfg.foreground_head`` the focal loss
    (alpha 0.75, gamma 2) of the fg logits against ``y > data_range[0]``
    joins the generator loss as ``gen_foreground_loss``. Dropout draws from
    the state's ``rng``."""
    if cfg.gan_train and (disc is None or disc_optimizer is None):
        raise ValueError("gan_train needs a discriminator and its optimizer")
    use_cell = cfg.use_cell_loss and cell_loss_fn is not None
    fg_loss = focal_bce_loss(alpha=0.75, gamma=2.0)

    def train_step(state: TrainState, batch, metrics: PixelMetrics):
        batch = _on_device(batch, state.device)
        x, y = batch["image"], batch["target"]
        names = [n for n, _ in state.gen_params]
        params = [p for _, p in state.gen_params]

        model.train()
        use_generator(model, state.rng)
        out = model(x)
        fake, fg_logits = out if cfg.foreground_head else (out, None)
        loss_sim = loss_reconstruct(y, fake)
        loss = loss_sim
        adv = torch.zeros((), device=state.device)
        if cfg.gan_train:
            # the generator drives D(fake) toward 0 (reference convention);
            # D's power iteration state is only read here
            logits = disc(x, fake, update_stats=False)
            adv = adversarial_loss(logits, torch.zeros_like(logits), cfg.lsgan)
            loss = loss + adv
        zero = torch.zeros((), device=state.device)
        cell = zero
        if use_cell:
            cell = cell_loss_fn(fake, y, batch["nuclei"])
            loss = loss + cell
        fg = zero
        if cfg.foreground_head:
            fg = fg_loss(fg_logits, (y > cfg.data_range[0]).to(y.dtype))
            loss = loss + fg
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        clip = {}
        if state.tp is not None:
            _reduce_tensor_parallel(grads, state)
            clip = {"sharded": state.tp.sharded, "group": state.mesh.model_group}
        elif state.mesh is not None:
            average_gradients(grads, state.grad_scales)
        gen_optimizer.step(params, grads, state.gen_opt_state, **clip)

        fake = fake.detach()
        log = {"gen_loss": loss.detach(), "gen_loss_sim": loss_sim.detach(),
               "gen_adv_loss": adv.detach(), "loss_cell": cell.detach(),
               "gen_foreground_loss": fg.detach(),
               "nan": torch.isnan(fake).any(), "grads": dict(zip(names, grads))}
        if cfg.gan_train:
            d_params = list(disc.parameters())
            logits_fake = disc(x, fake, update_stats=True)
            logits_real = disc(x, y, update_stats=True)
            # label noise 0.05, clipped (reference: src/models.py:158-165)
            fake_labels = torch.clamp(1.0 + 0.05 * _label_noise(logits_fake.shape, state.rng),
                                      0.0, 1.0)
            real_labels = torch.clamp(0.05 * _label_noise(logits_real.shape, state.rng), 0.0, 1.0)
            d_loss = (adversarial_loss(logits_fake, fake_labels, cfg.lsgan)
                      + adversarial_loss(logits_real, real_labels, cfg.lsgan)) / 2.0
            d_grads = torch.autograd.grad(d_loss, d_params)
            if state.mesh is not None:
                average_gradients(d_grads)
            disc_optimizer.step(d_params, d_grads, state.disc_opt_state)
            log["disc_adv_loss"] = d_loss.detach()

        metrics = metrics.update(torch.clamp(fake, *cfg.data_range), y, cfg.data_range)
        state.step += 1
        return state, metrics, log

    return train_step


def make_eval_step(model, loss_reconstruct: Callable, cfg: StepConfig = StepConfig()):
    """``(state, batch, metrics) -> (metrics, {"gen_loss_sim", "pred"})`` with
    BatchNorm on its running statistics and dropout off; the model's mode is
    restored. Of a foreground-head generator only the masks count."""

    def eval_step(state: TrainState, batch, metrics: PixelMetrics):
        batch = _on_device(batch, state.device)
        x, y = batch["image"], batch["target"]
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                fake = model(x)
        finally:
            model.train(was_training)
        if cfg.foreground_head:
            fake = fake[0]
        loss_sim = loss_reconstruct(y, fake)
        metrics = metrics.update(torch.clamp(fake, *cfg.data_range), y, cfg.data_range,
                                 mask=batch.get("mask"))
        return metrics, {"gen_loss_sim": loss_sim, "pred": fake}

    return eval_step


def make_predict_step(model, foreground_head: bool = False):
    """``(state, batch) -> masks`` in eval mode (the masks alone of a
    foreground-head generator)."""

    def predict_step(state: TrainState, batch):
        x = torch.as_tensor(batch["image"], device=state.device)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                out = model(x)
        finally:
            model.train(was_training)
        return out[0] if foreground_head else out

    return predict_step
