"""Qualitative prediction panels: H&E | GT | prediction per marker (the
port's copy of ``figures/prediction_panels.py``).

Usage:
  python -m mipheivit_tpu_torch.figures.prediction_panels --checkpoint_dir D
      --out_dir O [--n_tiles 4] [--seed 0] [--device cpu]

Runs the generator of the checkpoint dir (``load_serving_model``: bf16 on
the card through K1, K2 and K3; f32 on the CPU with ``--device cpu``) on
test tiles sampled from the config's test dataframe (the rows
``DataFrame.sample`` draws) and writes one panel PNG per tile with the H&E
input, then a (GT, prediction) column pair per marker, contrast-stretched
the way the reference displays mIF. matplotlib is imported where the
panel is drawn.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import load_yaml
from ..data.table import Table
from ..infer.tiles import load_serving_model, predictions_to_uint8
from ..slideio import TiffSlide, read_image


def _stretch(x: np.ndarray, pct: float = 99.5) -> np.ndarray:
    hi = max(float(np.percentile(x, pct)), 1.0)
    return np.clip(x.astype(np.float32) / hi, 0, 1)


def render_panel(he: np.ndarray, gt: np.ndarray, pred: np.ndarray, names, out_path: str) -> None:
    """he [H,W,3] uint8; gt/pred [H,W,C] uint8."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(names)
    fig, axes = plt.subplots(2, n + 1, figsize=(2.2 * (n + 1), 4.6))
    for row in range(2):
        axes[row, 0].imshow(he)
        axes[row, 0].set_ylabel(["ground truth", "prediction"][row])
    axes[0, 0].set_title("H&E")
    for c, name in enumerate(names):
        axes[0, c + 1].imshow(_stretch(gt[..., c]), cmap="magma", vmin=0, vmax=1)
        axes[0, c + 1].set_title(name, fontsize=9)
        axes[1, c + 1].imshow(_stretch(pred[..., c]), cmap="magma", vmin=0, vmax=1)
    for ax in axes.ravel():
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)
    plt.close(fig)


def predict_panels(checkpoint_dir: str, n_tiles: int = 4, seed: int = 0, device=None):
    """The panels' inputs: the marker names and, per sampled test tile,
    ``(he, gt, pred)`` (uint8 ``[H, W, 3]``, ``[H, W, C]``, ``[H, W, C]``),
    the generator on ``device`` (the card unless the CPU is asked for)."""
    from .._device import resolve_device

    cfg = load_yaml(str(Path(checkpoint_dir) / "config.yaml"))
    names = list(cfg.data.targ_channel_names)
    test_df = Table.read_csv(cfg.data.test_dataframe_path)
    sample = test_df.sample(min(n_tiles, len(test_df)), random_state=seed)
    first = read_image(sample.row(0)["image_path"])
    device = resolve_device(device)
    model, he_norm = load_serving_model(cfg, checkpoint_dir, first.shape[0], len(names), device)
    out = []
    for i in range(len(sample)):
        row = sample.row(i)
        he = read_image(row["image_path"])
        x = torch.from_numpy(np.asarray(he_norm(he), np.float32))[None].to(device)
        with torch.inference_mode():
            pred = predictions_to_uint8(model(x)[0].float().cpu().numpy())
        ts = TiffSlide(row["target_path"])
        gt = ts.read_region((0, 0), 0, ts.dimensions)
        ts.close()
        out.append((he, gt, pred))
    return names, out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--n_tiles", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    names, panels = predict_panels(args.checkpoint_dir, args.n_tiles, args.seed, args.device)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, (he, gt, pred) in enumerate(panels):
        render_panel(he, gt, pred, names, str(out / f"panel_{i}.png"))
    print(f"{len(panels)} panels -> {out}")


if __name__ == "__main__":
    main()
