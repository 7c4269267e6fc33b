"""The baseline generators' train step against the JAX package's, on the CPU:
one step of a tiny UNETR, ``unet_lora`` and ``unet`` (with the layer
decay), of the ``hemit`` generator and of ``unet_lora`` on ctranspath's
Swin, against JAX's ``make_train_step`` from the same weights with dropout
0 (``torch_family_helpers.train_step_matches_jax``). The GAN and
foreground-head steps are in ``test_torch_train_families_gan_fg.py``; the
partition, the layer decay, dropout and the trainer in
``test_torch_trainer_families.py``. The port's attention and K2 run their
plain versions.
"""

import pytest
import torch

from torch_family_helpers import train_step_matches_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("model_name", ["unet_lora", "unet"])
def test_train_step_matches_jax(model_name, monkeypatch):
    train_step_matches_jax(model_name, False, False, monkeypatch)


@pytest.mark.parametrize("model_name", ["hemit", "unet_lora@ctranspath"])
def test_swin_family_train_step_matches_jax(model_name, monkeypatch):
    """The ``hemit`` preset's generator (the tiny dual branch, top-k 100 of
    1024 positions; the gate and the Swin's last stage get no gradient in
    either package) and ``unet_lora`` on a tiny ctranspath (the conv stem's
    BatchNorms on their running statistics)."""
    train_step_matches_jax(model_name, False, False, monkeypatch)
