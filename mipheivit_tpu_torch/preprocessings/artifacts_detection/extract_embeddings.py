"""Foundation-model tile embeddings for artifact filtering (the port's copy
of ``preprocessings/artifacts_detection/extract_embeddings.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.artifacts_detection.extract_embeddings
      --tile_dataframe T.csv --out_dir D --encoder_weights E.safetensors
      [--encoder hoptimus0] [--img_size 224] [--batch_size 32]
      [--shard_size 4096] [--device cpu]

The ViT encoder's class token per tile, after the final norm: the tiles of
the dataframe's ``image_path`` column center-cropped to ``--img_size`` and
normalized with H-Optimus-0's constants on the host (``TileDataset``,
``Loader``), sent to the device by ``device_prefetch``, encoded in bf16 on
the card (K1 attention, K2 MLP; the JAX script runs bf16 on its
accelerator) or f32 on the CPU with ``--device cpu`` (without a card and
without it, it raises). The timm-layout encoder weights load strictly.
Embeddings go to ``embeddings_<i>.npy`` in f16 and the tile names to
``names_<i>.csv`` (a header line ``0``, then one name a line, as pandas
writes a Series), a shard every ``--shard_size`` tiles.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from ..._device import resolve_device
from ...data.augment import SpatialAugment
from ...data.dataset import TileDataset
from ...data.pipeline import Loader, device_prefetch
from ...data.stats import HOPTIMUS_MEAN, HOPTIMUS_STD, Normalizer
from ...data.table import Table
from ...infer.loading import load_state_dict, load_vit_encoder
from ...models.foundation import get_encoder_spec


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tile_dataframe", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--encoder", default="hoptimus0")
    parser.add_argument("--encoder_weights", required=True)
    parser.add_argument("--img_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--shard_size", type=int, default=4096)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    spec = get_encoder_spec(args.encoder, args.img_size)
    model = load_vit_encoder(spec.vit_cfg, load_state_dict(args.encoder_weights), device, dtype)

    norm = Normalizer({"mean": HOPTIMUS_MEAN, "std": HOPTIMUS_STD}, "he")
    dataset = TileDataset(Table.read_csv(args.tile_dataframe), preprocess_input_fn=norm,
                          spatial_augmentations=SpatialAugment(
                              args.img_size, args.img_size, training=False))
    loader = Loader(dataset, args.batch_size, num_workers=4, pad_to_batch=True)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    shard, names, shard_idx = [], [], 0

    def flush():
        nonlocal shard, names, shard_idx
        if not shard:
            return
        np.save(out_dir / f"embeddings_{shard_idx:04d}.npy",
                np.concatenate(shard).astype(np.float16))
        with open(out_dir / f"names_{shard_idx:04d}.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["0"])
            writer.writerows([n] for b in names for n in b)
        shard, names = [], []
        shard_idx += 1

    count = 0
    with torch.inference_mode():
        for batch in device_prefetch(loader, size=2, device=device):
            n = int(batch["mask"].sum())
            emb = model(batch["image"])[:, 0].float().cpu().numpy()[:n]
            shard.append(emb)
            names.append(list(batch["tile_name"][:n]))
            count += n
            if sum(s.shape[0] for s in shard) >= args.shard_size:
                flush()
    flush()
    print(f"{count} embeddings -> {out_dir}")


if __name__ == "__main__":
    main()
