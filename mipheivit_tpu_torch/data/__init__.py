"""The port's data layer: channel statistics and normalization codecs, CSV
tables, augmentations, the balanced sampler, the tile and slide datasets
with their ``DataModule``, and the threaded loader with ``device_prefetch``."""
