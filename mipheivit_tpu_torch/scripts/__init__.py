"""The port's copies of the repo's scripts: ``inference_hemit`` (the SMP
U-Net over the HEMIT test split), and the data preparation's
``scale_slides``, ``create_dataframe``, ``extract_std`` and
``ckpt_remove_foundation_model``. Each runs as ``python -m
mipheivit_tpu_torch.scripts.<name>``."""
