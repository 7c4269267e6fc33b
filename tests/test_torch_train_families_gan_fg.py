"""The baseline generators' train step with the GAN on and with the
foreground head, against the JAX package's, on the CPU: ``unet_lora`` with
the PatchGAN, as the GAN-ablation presets train, and the SMP U-Net with its
foreground term (``gen_foreground_loss``), each against JAX's
``make_train_step`` from the same weights with dropout 0
(``torch_family_helpers.train_step_matches_jax``).
"""

import torch

from torch_family_helpers import train_step_matches_jax

torch.set_num_threads(2)


def test_gan_train_step_matches_jax(monkeypatch):
    train_step_matches_jax("unet_lora", True, False, monkeypatch)


def test_foreground_head_train_step_matches_jax(monkeypatch):
    train_step_matches_jax("smp_unet", False, True, monkeypatch)
