"""HED (Haematoxylin-Eosin-DAB) stain color space, skimage-parity.

The reference's stain jitter converts to HED via ``skimage.color.rgb2hed``
(reference: src/augmentations.py:237,261). skimage is not available here,
so the Ruifrok-Johnston matrices and skimage's exact log-space convention
are reproduced (works on numpy or jax arrays; pure 3x3 matmuls, so it also
fuses nicely on device if augmentation is moved on-TPU).
"""

from __future__ import annotations

import numpy as np

# Ruifrok & Johnston stain vectors (skimage.color.rgb_from_hed)
RGB_FROM_HED = np.array(
    [[0.65, 0.70, 0.29],
     [0.07, 0.99, 0.11],
     [0.27, 0.57, 0.78]], dtype=np.float64)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED)

_LOG_ADJUST = np.log(1e-6)


def rgb2hed(rgb):
    """rgb in [0,1] float (or uint8, auto-scaled) -> HED stain concentrations.
    skimage ``separate_stains`` semantics."""
    xp = np
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float64) / 255.0
    rgb = np.maximum(rgb, 1e-6)
    stains = (np.log(rgb) / _LOG_ADJUST) @ HED_FROM_RGB
    return np.maximum(stains, 0)


def hed2rgb(hed):
    """skimage ``combine_stains`` semantics; returns float rgb in [0,1]."""
    hed = np.asarray(hed, dtype=np.float64)
    log_rgb = -(hed * (-_LOG_ADJUST)) @ RGB_FROM_HED
    rgb = np.exp(log_rgb)
    return np.clip(rgb, 0.0, 1.0)
