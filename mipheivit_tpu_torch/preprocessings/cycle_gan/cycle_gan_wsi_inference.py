"""WSI-scale CycleGAN stain normalisation (the port's copy of
``preprocessings/cycle_gan/cycle_gan_wsi_inference.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.cycle_gan.cycle_gan_wsi_inference
      --slide_path S --checkpoint G.pth --out_path O [--tile_size 512]
      [--batch_size 4] [--device cpu]

Reference: preprocessings/cycle_gan/cycle_gan_wsi_inference.py. The
normaliser runs over the slide tile by tile, without overlap (the
generator is close to shift-equivariant away from borders; the swap
augmentation tolerates seam pixels), in f32 batches of exactly
``batch_size`` (the last zero-filled) on the card unless ``--device cpu``
(without a card it raises); the normalised replica is written as a tiled
4-level pyramid. The uint8 codes are made on the host as the JAX script
makes them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ...infer.loading import load_state_dict
from ...slideio import SlideReader, write_pyramid
from .resnet_generator import build_generator, params_from_torch


def to_uint8(pred: np.ndarray) -> np.ndarray:
    """Generator output in [-1, 1] -> uint8, as the JAX scripts round it."""
    return ((pred + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def make_forward(model, batch_size: int):
    """``forward(tiles [n, H, W, 3] uint8)`` -> ``[n, H, W, 3]`` f32 in
    [-1, 1]: a batch of exactly ``batch_size`` (zero-filled) through the
    generator on its device."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def forward(tiles: np.ndarray) -> np.ndarray:
        n = len(tiles)
        x = np.zeros((batch_size,) + tiles.shape[1:], np.float32)
        x[:n] = tiles
        return model(torch.from_numpy(x).to(dev) / 127.5 - 1.0).cpu().numpy()[:n]

    return forward


def normalize_slide(reader, forward, tile_size: int, batch_size: int) -> np.ndarray:
    """The slide's normalised replica ``[3, H, W]`` uint8, tile by tile."""
    w, h = reader.dimensions
    out = np.zeros((3, h, w), np.uint8)
    tiles, coords = [], []

    def flush():
        if not tiles:
            return
        pred = to_uint8(forward(np.stack(tiles)))
        for img, (tx, ty) in zip(pred, coords):
            cw, ch = min(tile_size, w - tx), min(tile_size, h - ty)
            out[:, ty:ty + ch, tx:tx + cw] = img[:ch, :cw].transpose(2, 0, 1)
        tiles.clear()
        coords.clear()

    for ty in range(0, h, tile_size):
        for tx in range(0, w, tile_size):
            tiles.append(reader.read_region((tx, ty), 0, (tile_size, tile_size)))
            coords.append((tx, ty))
            if len(tiles) == batch_size:
                flush()
    flush()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_path", required=True)
    parser.add_argument("--checkpoint", required=True, help="CycleGAN generator .pth")
    parser.add_argument("--out_path", required=True)
    parser.add_argument("--tile_size", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    model = build_generator(params_from_torch(load_state_dict(args.checkpoint)),
                            device=args.device)
    reader = SlideReader(args.slide_path, mode="RGB")
    out = normalize_slide(reader, make_forward(model, args.batch_size), args.tile_size,
                          args.batch_size)
    write_pyramid(args.out_path, out, n_levels=4, tile_size=512, mpp=reader.mpp or 0.0)
    reader.close()
    print(f"normalized WSI -> {args.out_path}")


if __name__ == "__main__":
    main()
