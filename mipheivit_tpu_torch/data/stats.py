"""Channel statistics + normalization codec.

Preserves the reference data contract exactly (see SURVEY.md §1 "data
contract"): a ``channel_stats.json`` with one entry per mIF marker
(``idx_channel``, ``std``, ``is_structural``, ...) plus an ``RGB`` entry with
``mean``/``std``, and the two normalization codecs:

  * H&E input:  ``(x - mean) / std`` with *pixel-unit* (x255) constants that
    depend on the encoder (H-Optimus-0 uses its own constants)
    — reference: src/dataset.py:545-575, src/dataset.py:596-606.
  * mIF target: ``x / 255 * 1.8 - 0.9``  (uint8 -> [-0.9, 0.9]) and inverse
    ``(x + 0.9) * 255 / 1.8`` — reference: src/dataset.py:562-575.

The port's own copy of ``mipheivit_tpu/data/stats.py`` (the port imports
nothing of the JAX package). The codecs take numpy arrays or torch tensors.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

# Encoder-dependent H&E constants, in pixel units (x255)
# (reference: src/dataset.py:596-606).
HOPTIMUS_MEAN = np.array([0.707223, 0.578729, 0.703617], np.float32) * 255.0
HOPTIMUS_STD = np.array([0.211883, 0.230117, 0.177517], np.float32) * 255.0
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0

# mIF codec: uint8 [0,255] <-> [-0.9, 0.9]
IF_SCALE = 1.8 / 255.0
IF_OFFSET = -0.9


@dataclasses.dataclass
class ChannelStats:
    """Parsed ``channel_stats.json``.

    ``raw`` holds the verbatim JSON dict; helpers index per-marker entries in
    the order of ``targ_channel_names`` like the reference drivers do
    (reference: src/train.py:66-70).
    """

    raw: Dict[str, Any]

    @property
    def rgb(self) -> Dict[str, Any]:
        return self.raw["RGB"]

    def channel_idxs(self, channel_names: Sequence[str]) -> List[int]:
        return [int(self.raw[name]["idx_channel"]) for name in channel_names]

    def stats_list(self, channel_names: Sequence[str]) -> List[Dict[str, Any]]:
        return [self.raw[name] for name in channel_names]

    def stds(self, channel_names: Sequence[str]) -> np.ndarray:
        return np.array([self.raw[name]["std"] for name in channel_names], np.float32)

    def mins(self, channel_names: Sequence[str]) -> np.ndarray:
        return np.array([self.raw[name]["min"] for name in channel_names], np.float32)

    def structural_mask(self, channel_names: Sequence[str]) -> np.ndarray:
        return np.array(
            [bool(self.raw[name].get("is_structural", False)) for name in channel_names]
        )


def load_channel_stats(path: str) -> ChannelStats:
    with open(path, "r") as f:
        return ChannelStats(json.load(f))


def get_input_mean_std(model_name: str, encoder_name: Optional[str],
                       channel_stats_rgb: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Pick the H&E normalization constants for a given generator
    (reference: src/dataset.py:596-606)."""
    if model_name in ("cellvit", "vitmatte"):
        return {"mean": IMAGENET_MEAN, "std": IMAGENET_STD}
    if model_name.startswith("unet") or model_name.startswith("myvitmatte"):
        if encoder_name == "hoptimus0":
            return {"mean": HOPTIMUS_MEAN, "std": HOPTIMUS_STD}
        return {"mean": IMAGENET_MEAN, "std": IMAGENET_STD}
    return {
        "mean": np.asarray(channel_stats_rgb["mean"], np.float32),
        "std": np.asarray(channel_stats_rgb["std"], np.float32),
    }


def get_effective_width_height(width: int, height: int, train: bool = False):
    """Snap training tile size down to a power of two
    (reference: src/dataset.py:588-594)."""
    if train:
        width = int(2 ** np.floor(np.log2(width)))
        height = int(2 ** np.floor(np.log2(height)))
    return width, height


class Normalizer:
    """The two normalization codecs, usable on numpy arrays or torch tensors.

    mode="he":  channelwise ``(x - mean) / std`` (channels-last)
    mode="if":  ``x / 255 * 1.8 - 0.9`` with inverse ``(x + 0.9) * 255 / 1.8``

    Matches reference ``NormalizationLayer`` (src/dataset.py:545-575),
    including the "he" constructor taking either one RGB stats dict or a list
    of per-channel dicts.
    """

    def __init__(self, stats: Union[Dict, List[Dict], None] = None, mode: str = "he"):
        if mode not in ("he", "if"):
            raise ValueError(f"mode must be 'he' or 'if', got {mode!r}")
        self.mode = mode
        self.mean = None
        self.std = None
        if mode == "he":
            stats_list = stats if isinstance(stats, list) else [stats]
            mean = np.array([s["mean"] for s in stats_list], np.float32)
            std = np.array([s["std"] for s in stats_list], np.float32)
            self.mean = np.float32(mean.reshape((1, 1, -1)))
            self.std = np.float32(std.reshape((1, 1, -1)))

    def __call__(self, x):
        if self.mode == "he":
            mean, std = self.mean, self.std
            if hasattr(x, "ndim") and x.ndim == 4:  # NHWC batch
                mean = mean[None]
                std = std[None]
            return _affine(x, mean, std)
        return _to_f32(x) / 255.0 * 1.8 - 0.9

    def unormalize(self, x):
        if self.mode == "if":
            return (x + 0.9) * 255.0 / 1.8
        return x * self.std + self.mean

    # alias with the conventional spelling; reference uses "unormalize"
    unnormalize = unormalize


def _to_f32(x):
    if isinstance(x, np.ndarray):
        return np.float32(x)
    return x.float()


def _affine(x, mean, std):
    if not isinstance(x, np.ndarray):  # a torch tensor
        import torch

        mean = torch.as_tensor(mean, device=x.device)
        std = torch.as_tensor(std, device=x.device)
    return (_to_f32(x) - mean) / std
