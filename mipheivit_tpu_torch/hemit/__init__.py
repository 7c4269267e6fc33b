"""HEMIT on the card: the reproduction (``python -m
mipheivit_tpu_torch.hemit.train_hemit``) and ORION tiles in HEMIT's folder
layout (``python -m mipheivit_tpu_torch.hemit.orion_to_hemit_layout``)."""
