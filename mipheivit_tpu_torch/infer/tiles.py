"""Batch tile inference (PyTorch counterpart of ``mipheivit_tpu/infer/tiles.py``).

uint8 tiles go to the device as they are; the H&E normalization
``(x - mean) / std`` and the output codec to uint8 run there, so only uint8
crosses the bus in either direction. The ragged last batch is padded to the
batch size, as the JAX driver pads it to its compiled shape.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from .loading import cast_params, load_generator, merge_lora

log = logging.getLogger(__name__)


class HEStats(NamedTuple):
    """H&E normalization constants, three channels each, in pixel units."""

    mean: np.ndarray
    std: np.ndarray


# H-Optimus-0's constants (reference: src/dataset.py:596-606)
HOPTIMUS_HE = HEStats(np.array([0.707223, 0.578729, 0.703617], np.float32) * 255.0,
                      np.array([0.211883, 0.230117, 0.177517], np.float32) * 255.0)


def predictions_to_uint8(pred: np.ndarray) -> np.ndarray:
    """[-0.9, 0.9] -> uint8 (reference: src/callbacks.py:344-346)."""
    arr = np.clip((np.asarray(pred, np.float32) + 0.9) / 1.8, 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)


def _to_uint8(pred: torch.Tensor) -> torch.Tensor:
    """``predictions_to_uint8`` on the device, the same f32 operations in the
    same order."""
    return (torch.clamp((pred.float() + 0.9) / 1.8, 0.0, 1.0) * 255.0).to(torch.uint8)


def predict_tiles(model, tiles_uint8: np.ndarray, normalizer, batch_size: int = 64,
                  device=None) -> np.ndarray:
    """uint8 H&E tiles ``[N, H, W, 3]`` -> uint8 predictions ``[N, H, W, C]``.

    ``normalizer`` carries the H&E ``mean`` and ``std`` (three values each,
    in pixel units): ``HOPTIMUS_HE``, or a ``data.stats.Normalizer``.
    ``device`` defaults to the model's."""
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    mean = torch.as_tensor(np.asarray(normalizer.mean, np.float32).reshape(-1), device=device)
    std = torch.as_tensor(np.asarray(normalizer.std, np.float32).reshape(-1), device=device)
    n = len(tiles_uint8)
    outs = []
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            x = torch.from_numpy(np.ascontiguousarray(tiles_uint8[i:i + batch_size]))
            m = x.shape[0]
            x = x.to(device)
            if m < batch_size:  # keep one batch shape: pad the ragged last batch
                x = torch.cat([x, x.new_zeros((batch_size - m,) + x.shape[1:])])
            pred = model((x.float() - mean) / std)[:m]
            outs.append(_to_uint8(pred).cpu())
    return torch.cat(outs).numpy()


def save_prediction_tiff(pred_hwc: np.ndarray, out_path: str) -> None:
    """Per-tile multi-channel TIFF, written by the port's native TIFF engine."""
    from ..slideio import write_pyramid

    write_pyramid(out_path, np.moveaxis(pred_hwc, -1, 0), n_levels=1,
                  tile_size=min(512, max(64, pred_hwc.shape[0])))


def load_serving_model(cfg, checkpoint_dir: str, img_size, nc_out: int, device, dtype=None):
    """The generator of a run config's checkpoint dir at ``img_size``, ready
    to serve on ``device`` (LoRA merged; in ``dtype``, by default bf16 on a
    card and f32 on the CPU), and its H&E normalizer."""
    from ..data.stats import Normalizer, get_input_mean_std, load_channel_stats

    device = torch.device(device)
    model_name = cfg.model.model_name
    encoder_name = cfg.select("model.encoder.encoder_name", "hoptimus0")
    channel_stats = load_channel_stats(cfg.data.channel_stats_path)
    norm = Normalizer(get_input_mean_std(model_name, encoder_name, channel_stats.rgb),
                      mode="he")
    model = load_generator(
        model_name, encoder_name, checkpoint_dir, img_size, nc_out,
        dtype=torch.float32, device=device,
        encoder_ckpt_path=cfg.select("model.encoder.encoder_weights"),
        fast_heads=model_name.startswith("myvitmatte"))
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return cast_params(merge_lora(model), dtype), norm


def inference_model(cfg, checkpoint_dir: str, output_dir: str,
                    batch_size: Optional[int] = None, device=None) -> str:
    """Tile-mode ``run_inference``: predict every tile of the test dataframe
    (``image_path`` column) and write ``<tile>.tiff`` into ``output_dir``.

    ``cfg`` is a run config (``config.load_yaml``). Tiles are read and
    TIFFs written through the port's ``slideio``; slide-mode dataframes
    are not ported yet. Runs in bf16 on the card (the default; raises
    without one), in f32 on the CPU when ``device="cpu"``."""
    from ..data.stats import get_effective_width_height
    from ..slideio import read_image

    device = resolve_device(device)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    with open(cfg.data.test_dataframe_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows or "image_path" not in rows[0]:
        raise NotImplementedError("slide-mode inference is not ported yet; "
                                  "the test dataframe needs an image_path column")
    paths = [r["image_path"] for r in rows]
    nc_out = len(cfg.data.targ_channel_names)
    height, width = read_image(paths[0]).shape[:2]
    width, height = get_effective_width_height(width, height, train=True)
    log.info("inference at %dx%d, %d markers", width, height, nc_out)
    model, norm = load_serving_model(cfg, checkpoint_dir, (height, width), nc_out, device)

    batch = int(batch_size or cfg.train.batch_size)
    for i in range(0, len(paths), batch):
        chunk = paths[i:i + batch]
        tiles = np.stack([_center_crop(read_image(p), height, width) for p in chunk])
        preds = predict_tiles(model, tiles, norm, batch, device)
        for pred, path in zip(preds, chunk):
            save_prediction_tiff(pred, str(out_dir / f"{Path(path).stem}.tiff"))
    log.info("wrote %d prediction tiles to %s", len(paths), out_dir)
    return str(out_dir)


def _center_crop(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = arr.shape[:2]
    y0, x0 = (h - height) // 2, (w - width) // 2
    return arr[y0:y0 + height, x0:x0 + width]
