"""HEMIT reproduction: pix2pix-style training of the dual-branch generator.

Usage:
  python -m mipheivit_tpu_torch.hemit.train_hemit --data_root R --out_dir O
      [--epochs 20] [--batch_size 4] [--lr 2e-4] [--lambda_l1 100]
      [--crop 256] [--nc_out 3] [--num_workers 4] [--device cpu]

The port of ``hemit/train_hemit.py`` (reference: hemit/adapted_scripts, the
adapted pix2pix loop): the HEMIT folder layout ``<root>/<split>/{input,
label}/<name>`` (tiles paired by name; PNG, TIFF or ``.npy``), the IF
normalisation (``x / 255 * 1.8 - 0.9``) on both sides, random crops and
flips, ``models.hemit.build_hemit`` against the PatchGAN
``DiscriminatorPatch`` without norm layers, the GAN + L1 x 100 objective
through the port's train step (its Adam chain and pix2pix schedule), and
after each epoch the validation pixel metrics; the epoch with the best
``val_psnr`` is kept as a train-state snapshot in ``<out_dir>/best``
(``train.checkpoints.save_train_state``; ``restore_train_state`` reloads
it), the metrics go to ``<out_dir>/metrics.jsonl``. Batches reach the card
through the port's ``Loader`` and ``device_prefetch``. Runs on the card in
bf16 unless ``--device cpu`` is given (f32); without a card it raises.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..data.augment import get_augmentations
from ..data.dataset import TileImg2ImgDataset
from ..data.pipeline import Loader, device_prefetch
from ..data.stats import Normalizer
from ..data.table import Table
from ..metrics import PixelMetrics
from ..models.discriminator import DiscriminatorPatch
from ..models.hemit import build_hemit
from ..models.layers import set_compute_dtype
from ..train.checkpoints import save_train_state
from ..train.losses import mae_loss
from ..train.optim import build_discriminator_optimizer, build_generator_optimizer
from ..train.steps import StepConfig, create_train_state, make_eval_step, make_train_step
from ..utils import MetricsLogger

log = logging.getLogger("train_hemit")


def dataframe_from_folders(root: str, split: str) -> Table:
    """``<root>/<split>/input/*`` paired by name with ``.../label/*``."""
    base = Path(root) / split
    rows = [(str(img), str(base / "label" / img.name))
            for img in sorted((base / "input").glob("*")) if (base / "label" / img.name).exists()]
    return Table({"image_path": np.array([r[0] for r in rows], object),
                  "target_path": np.array([r[1] for r in rows], object)})


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--lambda_l1", type=float, default=100.0)
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--nc_out", type=int, default=3)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu to run on the CPU)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``{"history": [per-epoch validation metrics],
    "best_psnr", "best_path", "state"}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    train_df = dataframe_from_folders(args.data_root, "train")
    val_df = dataframe_from_folders(args.data_root, "val")
    log.info("%d train / %d val pairs", len(train_df), len(val_df))

    # HEMIT normalises both sides to the IF range (the pix2pix convention)
    norm = Normalizer(mode="if")
    spatial, _ = get_augmentations(args.crop, args.crop, True)
    eval_spatial, _ = get_augmentations(args.crop, args.crop, False)
    train_ds = TileImg2ImgDataset(train_df, preprocess_input_fn=norm, preprocess_target_fn=norm,
                                  spatial_augmentations=spatial)
    val_ds = TileImg2ImgDataset(val_df, preprocess_input_fn=norm, preprocess_target_fn=norm,
                                spatial_augmentations=eval_spatial)

    torch.manual_seed(0)
    with torch.device(device):
        model = build_hemit(args.crop, 3, args.nc_out)
        disc = DiscriminatorPatch(3 + args.nc_out)
    set_compute_dtype(model, torch.bfloat16 if device.type == "cuda" else None)
    total_iters = max(1, len(train_df) // args.batch_size * args.epochs)
    gen_opt = build_generator_optimizer(args.lr, total_iters)
    disc_opt = build_discriminator_optimizer(args.lr, total_iters)
    state = create_train_state(model, gen_opt, disc, disc_opt, device=device)
    loss = mae_loss(args.lambda_l1)
    train_step = make_train_step(model, loss, gen_opt, disc, disc_opt,
                                 StepConfig(gan_train=True))
    eval_step = make_eval_step(model, loss)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(str(out_dir), use_wandb=False)
    loader = Loader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                    num_workers=args.num_workers)
    best_psnr, best_path, history = -np.inf, None, []
    for epoch in range(args.epochs):
        loader.seed = epoch
        metrics = PixelMetrics.zeros(device)
        for batch in device_prefetch(loader, size=2, device=device):
            state, metrics, slog = train_step(
                state, {"image": batch["image"], "target": batch["target"]}, metrics)
            if bool(slog["nan"]):
                raise ValueError("Nan found")
        val_metrics = PixelMetrics.zeros(device)
        vloader = Loader(val_ds, args.batch_size, num_workers=args.num_workers,
                         pad_to_batch=True)
        for batch in device_prefetch(vloader, size=2, device=device):
            val_metrics, _ = eval_step(state, {"image": batch["image"], "target": batch["target"],
                                               "mask": batch["mask"]}, val_metrics)
        vm = {f"val_{k}": float(v) for k, v in val_metrics.compute().items()}
        vm["epoch"] = epoch
        logger.log(vm, step=state.step)
        history.append(vm)
        log.info("epoch %d: %s", epoch, vm)
        if vm["val_psnr"] > best_psnr:
            best_psnr = vm["val_psnr"]
            best_path = save_train_state(state, out_dir / "best", keep_last=1)
            log.info("new best val_psnr=%.3f", best_psnr)
    logger.finish()
    return {"history": history, "best_psnr": best_psnr, "best_path": best_path, "state": state}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
