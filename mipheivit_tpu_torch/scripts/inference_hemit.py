"""Batch inference of an SMP-style multi-head U-Net over the HEMIT
folder-layout test split, writing pix2pix-style triplet PNGs (the port's
copy of ``scripts/inference_hemit.py``).

Usage:
  python -m mipheivit_tpu_torch.scripts.inference_hemit --dataset_dir DS
      --checkpoint_path C.safetensors --output_dir O [--channel_stats S.json]
      [--encoder convnext] [--targ_channel_idxs 2] [--batch_size 16]
      [--device cpu]

``UnetMultiHeads`` (one head) over ``<dataset_dir>/test``, per tile:
``<i>_real_A.png`` (un-normalized H&E), ``<i>_fake_B.png`` (prediction
through the IF codec, uint8), ``<i>_real_B.png`` (target channel). The
ConvNeXt trunk is the importable one; checkpoints load from a Lightning
``.ckpt`` or safetensors state dict with the ``generator.`` prefix
stripped, strictly. Runs on the card (bf16 compute, f32 weights, as the
JAX script runs bf16 on its accelerator) or on the CPU with ``--device
cpu`` (f32); the U-Net's convolutions are cuDNN's, no kernel of the port.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.stats import Normalizer
from ..data.table import Table
from ..models.layers import set_compute_dtype
from ..models.smp_unet import UnetMultiHeads
from ..slideio import read_image


def dataframe_from_folders(root: str, split: str) -> Table:
    base = Path(root) / split
    rows = []
    for img in sorted((base / "input").glob("*")):
        label = base / "label" / img.name
        if label.exists():
            rows.append({"image_path": str(img), "target_path": str(label)})
    return Table.from_records(rows)


def load_model(checkpoint_path: str, encoder: str, device) -> UnetMultiHeads:
    """The one-head U-Net of ``checkpoint_path`` (``generator.`` prefix
    stripped where present), loaded strictly, in eval mode on ``device``."""
    from ..infer.loading import load_state_dict, load_strict

    state = load_state_dict(checkpoint_path)
    state = {k[len("generator."):]: v for k, v in state.items()
             if k.startswith("generator.")} or state
    model = UnetMultiHeads(encoder_name=encoder, out_chans=1, dropout=0.0)
    return load_strict(model, state).to(device).eval()


def main(argv=None):
    import cv2

    from .._device import resolve_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--channel_stats", default=None,
                        help="channel_stats.json for the H&E normalization")
    parser.add_argument("--encoder", default="convnext", choices=("resnet50", "convnext"),
                        help="convnext is the importable trunk; resnet50 only works with "
                             "matching-layout checkpoints")
    parser.add_argument("--targ_channel_idxs", type=int, nargs="*", default=[2])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    out_dir = Path(args.output_dir)
    image_dir = out_dir / "images"
    image_dir.mkdir(parents=True, exist_ok=True)

    rgb = {"mean": [127.5] * 3, "std": [127.5] * 3}
    if args.channel_stats:
        with open(args.channel_stats) as f:
            rgb = json.load(f)["RGB"]
    norm = Normalizer(rgb, mode="he")

    df = dataframe_from_folders(args.dataset_dir, "test")
    if len(df) == 0:
        raise SystemExit(f"no test pairs under {args.dataset_dir}/test")

    device = resolve_device(args.device)
    model = load_model(args.checkpoint_path, args.encoder, device)
    if device.type == "cuda":
        set_compute_dtype(model, torch.bfloat16)

    idx_image = 0
    for start in range(0, len(df), args.batch_size):
        chunk = df.take(np.arange(start, min(start + args.batch_size, len(df))))
        imgs = np.stack([read_image(p) for p in chunk["image_path"]])
        targs = [read_image(p) for p in chunk["target_path"]]
        x = norm(imgs.astype(np.float32))
        with torch.inference_mode():
            out = model(torch.from_numpy(np.ascontiguousarray(x)).to(device)).cpu().numpy()
        # IF codec decode [-0.9, 0.9] -> uint8 (reference :78)
        out = np.clip((out + 0.9) * 255.0 / 1.8, 0.0, 255.0).astype(np.uint8)
        real_a = np.clip(norm.unormalize(x), 0, 255).astype(np.uint8)
        for k in range(len(chunk)):
            t = targs[k]
            if t.ndim == 3:
                t = t[..., args.targ_channel_idxs]
            cv2.imwrite(str(image_dir / f"{idx_image}_real_A.png"), real_a[k][..., ::-1])
            cv2.imwrite(str(image_dir / f"{idx_image}_fake_B.png"), out[k, ..., 0])
            cv2.imwrite(str(image_dir / f"{idx_image}_real_B.png"), t[..., 0] if t.ndim == 3 else t)
            idx_image += 1
    print(f"{idx_image} tiles -> {image_dir}")


if __name__ == "__main__":
    main()
