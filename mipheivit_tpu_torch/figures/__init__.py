"""The port's copies of the repo's figure scripts that run a model:
``datasets_umap`` (the encoder's class tokens of sampled tiles, reduced to
2-D and scattered by split) and ``prediction_panels`` (the generator on
sampled test tiles, H&E | ground truth | prediction per marker). The
scripts run as ``python -m mipheivit_tpu_torch.figures.<script>``;
matplotlib (and umap-learn or scikit-learn for the 2-D map) are imported
only where they are used."""
