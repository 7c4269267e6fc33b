"""Stain-normalise tiles with a CycleGAN checkpoint (the port's copy of
``preprocessings/cycle_gan/normalize_tiles.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.cycle_gan.normalize_tiles
      --tile_dataframe T.csv --checkpoint G.pth --out_dir D [--batch_size 8]
      [--device cpu]

The generator runs over the dataframe's ``image_path`` tiles in batches on
the card unless ``--device cpu`` (without a card it raises); each output
keeps its source tile's name, so ``swap_augmentation_replicas`` finds it.
The dataframe is read with ``data.table`` (no pandas); cv2 writes the tiles.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...data.table import Table
from ...infer.loading import load_state_dict
from ...slideio import read_image
from .cycle_gan_wsi_inference import make_forward, to_uint8
from .resnet_generator import build_generator, params_from_torch


def main(argv=None):
    import cv2

    parser = argparse.ArgumentParser()
    parser.add_argument("--tile_dataframe", required=True)
    parser.add_argument("--checkpoint", required=True, help="CycleGAN generator .pth")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    model = build_generator(params_from_torch(load_state_dict(args.checkpoint)),
                            device=args.device)
    paths = list(Table.read_csv(args.tile_dataframe)["image_path"])
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        batch = np.stack([read_image(p) for p in chunk])
        # a batch of its own size, as the JAX script runs it
        pred = to_uint8(make_forward(model, len(chunk))(batch))
        for img, path in zip(pred, chunk):
            cv2.imwrite(str(out_dir / Path(path).name), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    print(f"normalized {len(paths)} tiles -> {out_dir}")


if __name__ == "__main__":
    main()
