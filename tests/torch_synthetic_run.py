"""A synthetic training run on disk for the port's trainer tests: TIFF tiles,
CSV dataframes, channel statistics and a checkpoint dir, written with numpy,
the stdlib and the port alone (no pandas, cv2 or jax), so that a process in
which those are unimportable can build it too.

Twelve 32-px tiles (H&E uint8 x 3, mIF uint8 x 2) split 8 / 2 / 2, the
tile tree of ``tests/test_trainer_e2e.py`` written as TIFF; with ``cells``
also int32 nuclei tiles (4 nuclei of 36 px a tile, ids unique to the
tile), the slide's nuclei CSV with their ground truth and the slide
dataframe, and a seeded cluster-MLP checkpoint for the cell loss.
"""

import csv
import json
from pathlib import Path

import numpy as np
import torch

MARKERS = ["CD31", "CD3e"]
# the tiny ViT of tests/test_trainer_e2e.py (head dim 16)
TINY = dict(img_size=(32, 32), patch_size=4, embed_dim=32, depth=2, num_heads=2,
            mlp_hidden_dim=64, reg_tokens=4, lora_rank=4)


def _write_csv(path: Path, rows):
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def write_run(root: Path, n_tiles: int = 12, seed: int = 0, cells: bool = False) -> dict:
    """Write tiles, dataframes and ``channel_stats.json`` (and with
    ``cells`` the nuclei, their CSVs and ``mlp.ckpt``) under ``root``;
    returns the config values that point at them."""
    from mipheivit_tpu_torch.slideio import write_pyramid

    rng = np.random.default_rng(seed)
    tiles = root / "tiles"
    tiles.mkdir(parents=True)
    rows, cell_rows = [], []
    for i in range(n_tiles):
        img, targ = tiles / f"t{i}.tiff", tiles / f"t{i}_mif.tiff"
        write_pyramid(str(img), rng.integers(0, 255, (3, 32, 32), dtype=np.uint8),
                      n_levels=1, tile_size=32)
        write_pyramid(str(targ), rng.integers(0, 255, (2, 32, 32), dtype=np.uint8),
                      n_levels=1, tile_size=32)
        rows.append({"image_path": str(img), "target_path": str(targ),
                     "in_slide_name": "s0", "CD31_count": i, "CD31_prop": 0.1,
                     "CD3e_count": 12 - i, "CD3e_prop": 0.05})
        if cells:
            nuclei = np.zeros((1, 32, 32), np.int32)
            for j in range(4):
                label = 100 + 4 * i + j
                y, x = 3 + 16 * (j // 2), 3 + 16 * (j % 2)
                nuclei[0, y:y + 6, x:x + 6] = label
                cell_rows.append({"label": label, "CD31_pos": label % 2 == 0,
                                  "CD3e_pos": label % 3 == 0})
            nuc = tiles / f"t{i}_nuc.tiff"
            write_pyramid(str(nuc), nuclei, n_levels=1, tile_size=32)
            rows[-1]["nuclei_path"] = str(nuc)
    n_train = n_tiles * 2 // 3
    n_val = (n_tiles - n_train) // 2
    splits = {"train": rows[:n_train], "val": rows[n_train:n_train + n_val],
              "test": rows[n_train + n_val:]}
    for split, part in splits.items():
        _write_csv(root / f"{split}.csv", part)
    stats = {
        "RGB": {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]},
        "CD31": {"idx_channel": 0, "std": 10.0, "min": 0, "is_structural": True},
        "CD3e": {"idx_channel": 1, "std": 12.0, "min": 0, "is_structural": False},
    }
    (root / "channel_stats.json").write_text(json.dumps(stats))
    slide_values = {"data.slide_dataframe_path": None}
    if cells:
        _write_csv(root / "cells.csv", cell_rows)
        _write_csv(root / "slides.csv", [{"in_slide_name": "s0", "in_slide_path": "",
                                          "targ_slide_path": "", "nuclei_slide_path": "",
                                          "nuclei_csv_path": str(root / "cells.csv")}])
        slide_values = {"data.slide_dataframe_path": str(root / "slides.csv"),
                        "train.losses.cell_loss.mlp_path": write_mlp(root / "mlp.ckpt")}
    return {f"data.{split}_dataframe_path": str(root / f"{split}.csv") for split in splits} | {
        **slide_values,
        "data.channel_stats_path": str(root / "channel_stats.json"),
        "data.targ_channel_names": list(MARKERS),
        "data.augmentation_dir": None,
    }


def write_mlp(path: Path, seed: int = 0) -> str:
    """A seeded cluster-MLP checkpoint for the cell loss, in the reference's
    key layout (``model.{0,1,3,5}.*``; 2 markers -> 16 -> 8 -> 2)."""
    g = torch.Generator().manual_seed(seed)
    n = len(MARKERS)
    state = {"model.0.mean": torch.full((n,), 127.0), "model.0.std": torch.full((n,), 40.0),
             "model.1.weight": torch.randn(16, n, generator=g),
             "model.1.bias": torch.randn(16, generator=g) * 0.1,
             "model.3.weight": torch.randn(8, 16, generator=g) * 0.3,
             "model.3.bias": torch.randn(8, generator=g) * 0.1,
             "model.5.weight": torch.randn(n, 8, generator=g) * 0.5,
             "model.5.bias": torch.randn(n, generator=g) * 0.1}
    torch.save(state, path)
    return str(path)


def tiny_generator(model_name, img_size, nc_out, encoder_name="hoptimus0",
                   dtype=torch.float32, device="cpu"):
    """Stands in for ``models.get_generator``: the tiny ViT's MipheiViT."""
    from mipheivit_tpu_torch.models import MipheiViT, ViTConfig

    assert img_size in (32, (32, 32)), img_size
    with torch.device(device):
        return MipheiViT(ViTConfig(**TINY), nc_out).eval()


def write_checkpoint(root: Path) -> Path:
    """A reference-layout ``model.safetensors`` of the tiny generator with
    plausible weights (LoRA B non-zero, layerscale at a trained magnitude);
    returns its path."""
    import sys

    from mipheivit_tpu_torch.io.safetensors import save_file

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from make_parity_fixtures import synth_state_dict

    model = tiny_generator("myvitmatte", (32, 32), len(MARKERS))
    keys = [(k, tuple(v.shape)) for k, v in model.state_dict().items() if v.is_floating_point()]
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    state.update(synth_state_dict(keys))
    ckpt = root / "ckpt"
    ckpt.mkdir()
    save_file(state, ckpt / "model.safetensors")
    return ckpt / "model.safetensors"


CELL_SETTINGS = {
    "train.use_cell_metrics": True, "train.losses.cell_loss.use_loss": True,
    "train.losses.cell_loss.use_mse": True, "train.losses.cell_loss.use_clustering": True,
    "train.callbacks.modelcheckpoint.monitor": "val_cell_auc",
    "train.callbacks.modelcheckpoint.mode": "max",
}


def configure(cfg, values: dict, cells: bool = False, **overrides):
    """Set dotted ``values`` and ``overrides`` (``a__b`` for ``a.b``) on a
    composed config of either package; the trainer tests' common settings:
    2 epochs of batch 4, no cell metrics, monitor ``val_gen_loss_sim``/min;
    with ``cells``, cell metrics and the cell loss (MSE and clustering) on,
    monitor ``val_cell_auc``/max (``values`` from ``write_run(cells=True)``)."""
    settings = {
        "train.epochs": 2, "train.batch_size": 4, "train.grad_accum_steps": 1,
        "train.use_cell_metrics": False, "train.gan_train": False,
        "train.gan_mode": "structural",
        "train.callbacks.modelcheckpoint.monitor": "val_gen_loss_sim",
        "train.callbacks.modelcheckpoint.mode": "min",
        **(CELL_SETTINGS if cells else {}),
        **values,
        **{k.replace("__", "."): v for k, v in overrides.items()},
    }
    for key, value in settings.items():
        cfg.set_dotted(key, value)
    return cfg
