"""A synthetic training run on disk for the port's trainer tests: TIFF tiles,
CSV dataframes, channel statistics and a checkpoint dir, written with numpy,
the stdlib and the port alone (no pandas, cv2 or jax), so that a process in
which those are unimportable can build it too.

Twelve 32-px tiles (H&E uint8 x 3, mIF uint8 x 2) split 8 / 2 / 2, the
tile tree of ``tests/test_trainer_e2e.py`` written as TIFF; with ``cells``
also int32 nuclei tiles (4 nuclei of 36 px a tile, ids unique to the
tile), the slide's nuclei CSV with their ground truth and the slide
dataframe, and a seeded cluster-MLP checkpoint for the cell loss.

Also the rank workers of the multi-rank trainer, CLI and int8 tests
(``train``, ``cli``, ``int8_forward``): the trainer or a CLI with a tiny
generator patched in, and, for the trainer, a write guard on every rank but
0 and a SIGTERM injected on one rank; the sequence-sharded forward of a
generator put through the int8 serving transforms.
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
                   dtype=torch.float32, device="cpu", **family_options):
    """Stands in for ``models.get_generator``: the tiny ViT's MipheiViT
    (which takes no ``dropout`` or ``foreground_head``)."""
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


# ---- rank workers of the multi-rank trainer and CLI tests -----------------
# (module-level, so that ``parallel.spawn`` children import them by name: a
# spawned process inherits ``sys.path``)

def _tiny_builder(vit_kwargs: dict):
    """``get_generator``'s signature over a MipheiViT of ``vit_kwargs``."""
    def build(model_name, img_size, nc_out, encoder_name="hoptimus0", dtype=torch.float32,
              device="cpu", **family_options):
        from mipheivit_tpu_torch.infer.loading import cast_params
        from mipheivit_tpu_torch.parallel.workers import build_generator

        return cast_params(build_generator(vit_kwargs, nc_out, device=device).eval(), dtype)

    return build


def _patched(module, **attrs):
    """Set ``attrs`` on ``module``; returns the undo."""
    old = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    return lambda: [setattr(module, name, value) for name, value in old.items()]


def _tiny_generators(vit_kwargs):
    """``get_generator`` of the trainer and the loaders replaced by
    ``_tiny_builder(vit_kwargs)``; the undo."""
    from mipheivit_tpu_torch.infer import loading
    from mipheivit_tpu_torch.train import trainer

    undo = [_patched(m, get_generator=_tiny_builder(vit_kwargs)) for m in (trainer, loading)]
    return lambda: [u() for u in undo]


def train(cfg_dict: dict, logdir: str, options: dict) -> dict:
    """``train_patchgan`` of ``Config.create(cfg_dict)`` into ``logdir`` on
    this rank, with the generator of ``options["tiny"]`` (ViT kwargs) in
    place of the preset's. Other ``options``: ``resume``, ``device``
    (default: the rank's), ``sigterm`` (``(rank, step)``: that rank sends
    itself SIGTERM after that many train steps), ``guard_writes`` (every
    rank but 0 raises on a write of the config, metrics, snapshots or the
    export) and ``return_params``. Returns the step, the preemption flag,
    the history, the generator's and the discriminator's digests (and
    parameters). The trainer module is restored afterwards."""
    import os
    import signal

    import torch.distributed as dist

    from mipheivit_tpu_torch.config import Config
    from mipheivit_tpu_torch.parallel.workers import digest
    from mipheivit_tpu_torch.train import trainer

    rank = dist.get_rank() if dist.is_initialized() else 0
    undo = [_tiny_generators(options["tiny"])]
    if options.get("guard_writes") and rank != 0:
        def refuse(*a, **kw):
            raise AssertionError(f"rank {rank} tried to write")

        undo.append(_patched(trainer, MetricsLogger=refuse, save_config=refuse,
                             save_train_state=refuse, save_generator=refuse))
    target = options.get("sigterm")
    if target is not None and target[0] == rank:
        real = trainer.make_train_step

        def make_train_step(*a, **kw):
            step_fn = real(*a, **kw)
            taken = [0]

            def run(*args):
                out = step_fn(*args)
                taken[0] += 1
                if taken[0] == target[1]:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            return run

        undo.append(_patched(trainer, make_train_step=make_train_step))
    try:
        out = trainer.train_patchgan(Config.create(cfg_dict), logdir, use_wandb=False,
                                     resume=options.get("resume", False),
                                     device=options.get("device"))
    finally:
        for u in reversed(undo):
            u()
    state = out["state"]
    res = {"step": state.step, "preempted": bool(out.get("preempted", False)),
           "history": out["history"], "digest": digest(state.generator.state_dict()),
           "disc_digest": digest(state.disc.state_dict()) if state.disc is not None else None}
    if options.get("return_params"):
        res["params"] = {k: v.detach().float().cpu().numpy()
                         for k, v in state.generator.state_dict().items() if v.is_floating_point()}
    return res


def cli(module: str, argv, tiny: dict):
    """``main(argv)`` of the port's CLI ``module`` (``"run"``,
    ``"run_inference"``) on this rank, with the generator of ``tiny`` (ViT
    kwargs) in place of the preset's or the checkpoint's."""
    import importlib

    main = importlib.import_module(f"mipheivit_tpu_torch.{module}").main
    undo = _tiny_generators(tiny)
    try:
        return main(list(argv))
    finally:
        undo()


def int8_forward(vit_kwargs: dict, out_chans: int, state, x, int8_state=None):
    """The eval forward of a MipheiViT of ``vit_kwargs`` with its tokens
    sharded over every rank, after ``infer.loading.quantize_encoder`` and
    ``quantize_decoder``: quantised from the float ``state``, or with
    ``int8_state`` (JAX's int8 tree through ``state_dict_from_jax``) loaded
    over the quantised modules. Returns the output ``[B, H, W, C]``."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.infer.loading import (load_strict, quantize_decoder,
                                                   quantize_encoder)
    from mipheivit_tpu_torch.parallel.mesh import make_mesh
    from mipheivit_tpu_torch.parallel.seq import seq_shard_scope
    from mipheivit_tpu_torch.parallel.workers import build_generator

    model = build_generator({**vit_kwargs, "attn_impl": "seq_shard"}, out_chans,
                            None if int8_state is not None else state).eval()
    quantize_decoder(quantize_encoder(model))
    if int8_state is not None:
        load_strict(model, {k: torch.from_numpy(np.array(v)) for k, v in int8_state.items()})
    with torch.no_grad(), seq_shard_scope(make_mesh(1, dist.get_world_size())):
        return model(torch.from_numpy(x)).numpy()
