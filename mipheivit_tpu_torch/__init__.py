"""PyTorch port of mipheivit_tpu for NVIDIA Hopper (H100)."""
