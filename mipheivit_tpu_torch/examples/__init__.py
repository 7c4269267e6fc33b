"""The port's copy of the repo's demo, ``examples/roi_inference.py``: an H&E
region through the generator, then nuclei, per-cell marker means and
gating. Runs as ``python -m mipheivit_tpu_torch.examples.roi_inference``."""
