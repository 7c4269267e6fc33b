"""The baseline generators' train step against the JAX package's, on the CPU:
one step of a tiny UNETR, ``unet_lora`` and ``unet`` (with the layer
decay), against JAX's ``make_train_step`` from the same weights with dropout
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
