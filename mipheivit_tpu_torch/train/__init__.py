"""Training (PyTorch): losses, schedules, the optimizer chain, the steps,
the train-state snapshots and the reference-format export. The driver is
``train.trainer.train_patchgan`` (and ``train.test_driver.test_model``)."""

from .checkpoints import (generator_state_dict, latest_checkpoint, restore_train_state,
                          save_generator, save_train_state)
from .losses import adversarial_loss, build_reconstruction_loss, weighted_mse_loss
from .optim import AdamChain, build_discriminator_optimizer, build_generator_optimizer
from .schedule import pix2pix_schedule, scaled_lr, vit_layer_decay_rate
from .steps import (StepConfig, TrainState, create_train_state, make_eval_step,
                    make_predict_step, make_train_step)

__all__ = [
    "AdamChain", "StepConfig", "TrainState", "adversarial_loss", "build_discriminator_optimizer",
    "build_generator_optimizer", "build_reconstruction_loss", "create_train_state",
    "generator_state_dict", "latest_checkpoint", "make_eval_step", "make_predict_step",
    "make_train_step", "pix2pix_schedule", "restore_train_state", "save_generator",
    "save_train_state", "scaled_lr", "vit_layer_decay_rate", "weighted_mse_loss",
]
