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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .._device import resolve_device
from ..metrics.pixel import PixelMetrics
from .losses import adversarial_loss
from .optim import AdamChain, OptState, set_trainable


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


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX ``StepConfig`` without the foreground head and the cell loss,
    which are not ported yet, and without ``freeze_model_name``: the
    trainable partition is the state's (``create_train_state``)."""

    gan_train: bool = False
    lsgan: bool = False
    data_range: tuple = (-0.9, 0.9)


def create_train_state(model: torch.nn.Module, gen_optimizer: AdamChain, disc=None,
                       disc_optimizer: Optional[AdamChain] = None,
                       freeze_model_name: Optional[str] = None,
                       frozen_dtype: Optional[torch.dtype] = None, seed: int = 0,
                       device=None, grad_checkpointing: bool = False) -> TrainState:
    """Move the generator (and discriminator) to ``device`` in training mode,
    mark the trainable parameters (``freeze_model_name``, the JAX package's
    ``optim.is_trainable`` rule; None: all of them), store the frozen
    ones in ``frozen_dtype`` when given (the JAX package's ``frozen_dtype``:
    bit-identical in the step, half the memory in bf16), and initialise the
    optimizer states for the trainable parameters only.
    ``grad_checkpointing`` recomputes each encoder block in the backward."""
    device = resolve_device(device)
    model.to(device).train()
    gen_params = set_trainable(model, freeze_model_name or "", frozen_dtype)
    model.encoder.vit.grad_checkpointing = grad_checkpointing
    state = TrainState(step=0, generator=model, gen_params=gen_params,
                       gen_opt_state=gen_optimizer.init([p for _, p in gen_params]),
                       rng=torch.Generator(device=device).manual_seed(seed), device=device)
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


def make_train_step(model, loss_reconstruct: Callable, gen_optimizer: AdamChain,
                    disc=None, disc_optimizer: Optional[AdamChain] = None,
                    cfg: StepConfig = StepConfig()):
    """The train step: ``(state, batch, metrics) -> (state, metrics, log)``.

    batch: ``{"image": [B, H, W, 3], "target": [B, H, W, C]}`` (numpy or
    torch; moved to the state's device). ``log`` holds the losses as 0-d
    tensors (the JAX step's keys; ``loss_cell`` and ``gen_foreground_loss``
    are 0, their terms not being ported), the NaN flag, and ``grads``: this
    microbatch's gradients of the trainable parameters by name (before
    clipping)."""
    if cfg.gan_train and (disc is None or disc_optimizer is None):
        raise ValueError("gan_train needs a discriminator and its optimizer")

    def train_step(state: TrainState, batch, metrics: PixelMetrics):
        batch = _on_device(batch, state.device)
        x, y = batch["image"], batch["target"]
        names = [n for n, _ in state.gen_params]
        params = [p for _, p in state.gen_params]

        model.train()
        fake = model(x)
        loss_sim = loss_reconstruct(y, fake)
        loss = loss_sim
        adv = torch.zeros((), device=state.device)
        if cfg.gan_train:
            # the generator drives D(fake) toward 0 (reference convention);
            # D's power iteration state is only read here
            logits = disc(x, fake, update_stats=False)
            adv = adversarial_loss(logits, torch.zeros_like(logits), cfg.lsgan)
            loss = loss + adv
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        gen_optimizer.step(params, grads, state.gen_opt_state)

        fake = fake.detach()
        zero = torch.zeros((), device=state.device)    # the unported cell and foreground terms
        log = {"gen_loss": loss.detach(), "gen_loss_sim": loss_sim.detach(),
               "gen_adv_loss": adv.detach(), "loss_cell": zero, "gen_foreground_loss": zero,
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
            disc_optimizer.step(d_params, d_grads, state.disc_opt_state)
            log["disc_adv_loss"] = d_loss.detach()

        metrics = metrics.update(torch.clamp(fake, *cfg.data_range), y, cfg.data_range)
        state.step += 1
        return state, metrics, log

    return train_step


def make_eval_step(model, loss_reconstruct: Callable, cfg: StepConfig = StepConfig()):
    """``(state, batch, metrics) -> (metrics, {"gen_loss_sim", "pred"})`` with
    BatchNorm on its running statistics; the model's mode is restored."""

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
        loss_sim = loss_reconstruct(y, fake)
        metrics = metrics.update(torch.clamp(fake, *cfg.data_range), y, cfg.data_range,
                                 mask=batch.get("mask"))
        return metrics, {"gen_loss_sim": loss_sim, "pred": fake}

    return eval_step


def make_predict_step(model):
    def predict_step(state: TrainState, batch):
        x = torch.as_tensor(batch["image"], device=state.device)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return model(x)
        finally:
            model.train(was_training)

    return predict_step
