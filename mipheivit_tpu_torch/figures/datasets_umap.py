"""2-D embedding map of dataset tiles through a foundation encoder (the
port's copy of ``figures/datasets_umap.py``).

Usage:
  python -m mipheivit_tpu_torch.figures.datasets_umap --train_csv A.csv
      --val_csv B.csv --test_csv C.csv --out_path map.png
      [--encoder hoptimus0] [--encoder_ckpt E.safetensors]
      [--n_per_split 500] [--seed 0] [--device cpu]

Samples tiles from the train/val/test dataframes (the rows
``DataFrame.sample`` draws), embeds each through the ViT encoder's class
token on the card (f32, as the JAX script runs; K1 and K2) or on the CPU
with ``--device cpu``, reduces to 2-D (umap-learn when installed,
scikit-learn's PCA otherwise, as the original) and scatters them coloured
by split. Without ``--encoder_ckpt`` the encoder keeps a random init from
``--seed`` (a geometry-only map; PyTorch's initialisers, not JAX's).
matplotlib and the reducer are imported where they are used.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.stats import Normalizer
from ..data.table import Table
from ..slideio import read_image


def embed_tiles(df: Table, encoder_apply, normalizer, batch_size: int = 16) -> np.ndarray:
    """The class token of each ``image_path`` tile of ``df``: ``encoder_apply``
    takes a normalized f32 batch ``[B, H, W, 3]`` (numpy) and returns its
    ``[B, D]`` embeddings (numpy)."""
    embs = []
    paths = list(df["image_path"])
    for i in range(0, len(paths), batch_size):
        tiles = [np.asarray(normalizer(read_image(p)), np.float32)
                 for p in paths[i:i + batch_size]]
        embs.append(np.asarray(encoder_apply(np.stack(tiles))))
    return np.concatenate(embs)


def reduce_2d(embs: np.ndarray, seed: int = 0) -> np.ndarray:
    try:
        import umap

        return umap.UMAP(random_state=seed).fit_transform(embs)
    except ImportError:
        from sklearn.decomposition import PCA

        return PCA(n_components=2, random_state=seed).fit_transform(embs)


def plot_embedding(coords: np.ndarray, labels, out_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4.5))
    for name in sorted(set(labels)):
        mask = np.asarray([lab == name for lab in labels])
        ax.scatter(coords[mask, 0], coords[mask, 1], s=8, alpha=0.6, label=name)
    ax.legend(markerscale=2, frameon=False)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)
    plt.close(fig)


def sample_splits(train_csv: str, val_csv: str, test_csv: str, n_per_split: int,
                  seed: int) -> dict:
    """``{split: Table}``: each dataframe's sample of ``n_per_split`` rows (all
    of a shorter one), the rows pandas' ``sample(random_state=seed)`` draws."""
    dfs = {name: Table.read_csv(path) for name, path in
           (("train", train_csv), ("val", val_csv), ("test", test_csv))}
    return {k: v.sample(min(n_per_split, len(v)), random_state=seed) for k, v in dfs.items()}


def build_encoder(encoder: str, img_size: int, encoder_ckpt=None, seed: int = 0, device=None):
    """The split sample's encoder and its H&E normalizer: ``encoder``'s ViT at
    ``img_size`` without LoRA, loaded from ``encoder_ckpt`` (timm layout)
    or randomly initialised from ``seed``; f32 on ``device`` (the card
    unless the CPU is asked for). Returns ``(apply, normalizer)``, where
    ``apply`` maps a normalized numpy batch to its class tokens."""
    from .._device import resolve_device
    from ..data.stats import HOPTIMUS_MEAN, HOPTIMUS_STD, IMAGENET_MEAN, IMAGENET_STD
    from ..infer.loading import load_state_dict, load_vit_encoder
    from ..models.foundation import get_encoder_spec
    from ..models.vit import VisionTransformer

    device = resolve_device(device)
    spec = get_encoder_spec(encoder, (img_size, img_size))
    if spec.family != "vit":
        raise SystemExit(f"embedding map needs a ViT encoder, got {spec.family}")
    cfg = spec.vit_cfg.replace(lora_rank=0)
    if encoder_ckpt:
        model = load_vit_encoder(cfg, load_state_dict(encoder_ckpt), device)
    else:
        torch.manual_seed(seed)
        model = VisionTransformer(cfg).to(device).eval()
    if encoder == "hoptimus0":
        mean, std = HOPTIMUS_MEAN, HOPTIMUS_STD
    else:
        mean, std = IMAGENET_MEAN, IMAGENET_STD

    def apply(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return model(torch.from_numpy(x).to(device))[:, 0].float().cpu().numpy()

    return apply, Normalizer({"mean": mean, "std": std}, "he")


def embed_splits(dfs: dict, apply, normalizer):
    """The class tokens of every split's tiles, in split order, and their
    split labels."""
    embs, labels = [], []
    for name, df in dfs.items():
        embs.append(embed_tiles(df, apply, normalizer))
        labels += [name] * len(df)
    return np.concatenate(embs), labels


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_csv", required=True)
    parser.add_argument("--val_csv", required=True)
    parser.add_argument("--test_csv", required=True)
    parser.add_argument("--out_path", required=True)
    parser.add_argument("--encoder", default="hoptimus0")
    parser.add_argument("--encoder_ckpt", default=None,
                        help="safetensors/torch encoder weights; random init without "
                             "(geometry-only map)")
    parser.add_argument("--n_per_split", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    dfs = sample_splits(args.train_csv, args.val_csv, args.test_csv, args.n_per_split, args.seed)
    img_size = read_image(dfs["train"].row(0)["image_path"]).shape[0]
    apply, normalizer = build_encoder(args.encoder, img_size, args.encoder_ckpt, args.seed,
                                      args.device)
    embs, labels = embed_splits(dfs, apply, normalizer)
    coords = reduce_2d(embs, args.seed)
    plot_embedding(coords, labels, args.out_path)
    print(f"embedding map ({len(labels)} tiles) -> {args.out_path}")


if __name__ == "__main__":
    main()
