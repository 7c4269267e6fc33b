"""The port's copies of the repo's scripts that run a model:
``inference_hemit`` (the SMP U-Net over the HEMIT test split). Runs as
``python -m mipheivit_tpu_torch.scripts.inference_hemit``."""
