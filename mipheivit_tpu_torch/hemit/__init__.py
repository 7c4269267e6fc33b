"""HEMIT reproduction on the card (``python -m mipheivit_tpu_torch.hemit.train_hemit``)."""
