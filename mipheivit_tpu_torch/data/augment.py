"""Host-side augmentations (albumentations-free).

Reproduces the reference pipeline (reference: src/dataset.py:458-483 +
src/augmentations.py):

  spatial (joint over image / image_target / nuclei):
    RandomCrop(pow2) -> HFlip(0.5) -> VFlip(0.5) -> CoarseDropout(p=0.1,
    1 hole, h/w each 0-30% of the tile, fill 0)
  color (H&E image only):
    HED stain jitter (sigma=bias=+-0.015, p=0.25, cutoff mean in
    [0.05, 0.95]) -> RandomBrightnessContrast(+-0.2, p=0.5) ->
    GaussianBlur(k=7, sigma 0.1-1.5, p=0.1) -> GaussNoise(std 5-10% of
    255, p=0.1); output clipped to [0, 255] (src/dataset.py:290-291).
  eval: CenterCrop only.

These run on the host input pipeline like the reference's DataLoader
workers; randomness is an explicit ``np.random.Generator``, drawn in the
same order as in ``mipheivit_tpu/data/augment.py``, of which this is the
port's copy. The blur is numpy, not cv2 (which the machine with the card
need not have): cv2's 7x7 kernel (``getGaussianKernel``, rounded to f32) applied
separably, rows then columns, over a ``BORDER_REFLECT_101`` border; it
agrees with ``cv2.GaussianBlur`` to ~1e-4 on the 0-255 scale.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops.hed import hed2rgb, rgb2hed


def center_crop(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = arr.shape[:2]
    y0 = (h - height) // 2
    x0 = (w - width) // 2
    return arr[y0:y0 + height, x0:x0 + width]


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2's ``getGaussianKernel(ksize, sigma)`` for a float image: computed
    in f64, normalised to sum 1, rounded to f32."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t / t.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float, ksize: int = 7) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigmaX=sigma)`` on an HWC f32
    image: the symmetric taps summed pairwise, along W then along H, with
    the border reflected without repeating the edge pixel."""
    w = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    for axis in (1, 0):
        x = np.moveaxis(img, axis, 0)
        n = x.shape[0]
        p = np.pad(x, [(r, r)] + [(0, 0)] * (x.ndim - 1), mode="reflect")
        acc = w[r] * p[r:r + n]
        for k in range(1, r + 1):
            acc = acc + w[r + k] * (p[r - k:r - k + n] + p[r + k:r + k + n])
        img = np.moveaxis(acc, 0, axis)
    return np.ascontiguousarray(img)


class SpatialAugment:
    """Joint spatial transform over a dict of aligned arrays (HWC or HW)."""

    def __init__(self, height: int, width: int, training: bool = True,
                 dropout_p: float = 0.1):
        self.height = height
        self.width = width
        self.training = training
        self.dropout_p = dropout_p

    def __call__(self, arrays: Dict[str, np.ndarray],
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        h, w = next(iter(arrays.values())).shape[:2]
        ch, cw = self.height, self.width
        if not self.training:
            return {k: center_crop(v, ch, cw) for k, v in arrays.items()}

        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        out = {k: v[y0:y0 + ch, x0:x0 + cw] for k, v in arrays.items()}
        if rng.random() < 0.5:
            out = {k: v[:, ::-1] for k, v in out.items()}
        if rng.random() < 0.5:
            out = {k: v[::-1] for k, v in out.items()}
        if rng.random() < self.dropout_p:
            hole_h = int(rng.uniform(0.0, 0.3) * ch)
            hole_w = int(rng.uniform(0.0, 0.3) * cw)
            if hole_h > 0 and hole_w > 0:
                hy = int(rng.integers(0, ch - hole_h + 1))
                hx = int(rng.integers(0, cw - hole_w + 1))
                for k, v in out.items():
                    v = v.copy()
                    v[hy:hy + hole_h, hx:hx + hole_w] = 0
                    out[k] = v
        return {k: np.ascontiguousarray(v) for k, v in out.items()}


class HedColorAugment:
    """HED-space stain jitter (reference: src/augmentations.py:28-273)."""

    def __init__(self, thresh: float = 0.015, p: float = 0.25,
                 cutoff: Tuple[float, float] = (0.05, 0.95)):
        self.thresh = thresh
        self.p = p
        self.cutoff = cutoff

    def __call__(self, image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.random() >= self.p:
            return image
        sigmas = rng.uniform(-self.thresh, self.thresh, 3)
        biases = rng.uniform(-self.thresh, self.thresh, 3)
        is_float = image.dtype.kind == "f"
        mean = image.mean() if is_float else image.astype(np.float32).mean() / 255.0
        if not (self.cutoff[0] <= mean <= self.cutoff[1]):
            return image
        hed = rgb2hed(image)
        for c in range(3):
            hed[..., c] = hed[..., c] * (1.0 + sigmas[c]) + biases[c]
        out = hed2rgb(hed)
        if not is_float:
            return (out * 255.0).astype(np.uint8)
        return out.astype(image.dtype)


class ColorAugment:
    """HED jitter + brightness/contrast + blur + noise on the H&E tile."""

    def __init__(self, hed_thresh: float = 0.015, hed_p: float = 0.25,
                 bc_limit: float = 0.2, bc_p: float = 0.5,
                 blur_p: float = 0.1, noise_p: float = 0.1):
        self.hed = HedColorAugment(hed_thresh, hed_p)
        self.bc_limit = bc_limit
        self.bc_p = bc_p
        self.blur_p = blur_p
        self.noise_p = noise_p

    def __call__(self, image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        image = self.hed(image, rng)
        img = image.astype(np.float32)
        if rng.random() < self.bc_p:
            alpha = 1.0 + rng.uniform(-self.bc_limit, self.bc_limit)
            beta = rng.uniform(-self.bc_limit, self.bc_limit)
            img = img * alpha + beta * 255.0
        if rng.random() < self.blur_p:
            sigma = rng.uniform(0.1, 1.5)
            img = gaussian_blur(img, sigma)
        if rng.random() < self.noise_p:
            std = rng.uniform(0.05, 0.1) * 255.0
            img = img + rng.normal(0.0, std, img.shape).astype(np.float32)
        # reference clips after color augs (src/dataset.py:290-291)
        return np.clip(img, 0, 255)


def get_augmentations(width: int, height: int, training: bool = True):
    """Factory mirroring the reference signature
    (src/dataset.py:458-483): returns (spatial, color-or-None)."""
    spatial = SpatialAugment(height, width, training=training)
    color = ColorAugment() if training else None
    return spatial, color
