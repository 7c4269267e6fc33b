"""The port's copies of the repo's demos: ``roi_inference`` (an H&E region
through the generator, then nuclei, per-cell marker means and gating) and
``visualize_dataset`` (a contact sheet of tiles). Each runs as ``python -m
mipheivit_tpu_torch.examples.<name>``."""
