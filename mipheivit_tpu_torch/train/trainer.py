"""Training driver: the full ``run.py`` path (reference: src/train.py:34-210).

The port's counterpart of ``mipheivit_tpu/train/trainer.py``, step for
step: dataframes + channel stats + normalizers + sampler + DataModule +
generator + reconstruction loss + (optional) PatchGAN discriminator +
optimizers into the train step, the epoch loop with validation and
checkpoint monitoring, resumable snapshots (``train/checkpoints.py``) and
the reference-format ``model.safetensors`` export of the best epoch.

The hot loop makes no host sync per step: the step's scalars are summed on
the card and fetched every ``log_every`` steps, and the first step with a
NaN output is tracked there too (a running minimum of ``where(nan, step,
INT_MAX)``), so the forensic dump (``weights_nan.safetensors`` and
``weights_nan.step``) names it exactly (reference: src/models.py:102-105).
Batches reach the card through ``data.pipeline.device_prefetch``.

With ``train.use_cell_metrics`` and a slide dataframe, the loaders return
the nuclei masks, validation and test pool the predictions per nucleus
(``metrics.cell.CellMetrics``; the test split reuses validation's logreg
head) and log ``{split}_cell_{auc,auc_logreg,balanced_acc,f1}`` and their
per-marker keys, which ``monitor: val_cell_auc`` reads. With
``train.losses.cell_loss.use_loss`` the step adds the cell loss
(``train.cell_loss``) on the training batch's nuclei.

Runs on the card unless ``device="cpu"`` is given (without a card it
raises), with the frozen foundation encoder stored and run in bf16 on the
card and f32 on the CPU. Not ported yet, and refused before any work: the
foreground head (ROADMAP.md queue 1, item 15: only the SMP U-Net has one),
``model.attn_impl=seq_shard`` (items 13-14) and more than one process
(item 13).
"""

from __future__ import annotations

import logging
import os
import signal
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..config import Config, save_config
from ..data.dataset import DataModule
from ..data.pipeline import device_prefetch
from ..data.sampler import BalancedPositiveSampler
from ..data.stats import (Normalizer, get_effective_width_height, get_input_mean_std,
                          load_channel_stats)
from ..data.table import Table
from ..infer.loading import load_generator
from ..metrics import PixelMetrics
from ..metrics.cell import METRIC_KEYS, CellMetrics
from ..models import get_generator
from ..models.discriminator import DiscriminatorPatch
from ..utils import MetricsLogger, save_image_grid
from .cell_loss import build_cell_loss
from .checkpoints import latest_checkpoint, restore_train_state, save_generator, save_train_state
from .losses import build_reconstruction_loss
from .optim import build_discriminator_optimizer, build_generator_optimizer
from .schedule import scaled_lr
from .steps import StepConfig, create_train_state, make_eval_step, make_train_step

log = logging.getLogger(__name__)

LOG_EVERY = 50          # steps between fetches of the step scalars
_NO_NAN = np.iinfo(np.int32).max


def _n_processes() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def refuse_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for what the port cannot train yet."""
    if cfg.select("train.foreground_head"):
        raise NotImplementedError(
            "the foreground head is not ported to PyTorch yet (ROADMAP.md queue 1, item 15: "
            "only the SMP U-Net generator of the JAX package has one)")
    if cfg.select("model.attn_impl", "auto") == "seq_shard":
        raise NotImplementedError(
            "model.attn_impl=seq_shard is not ported to PyTorch yet (ROADMAP.md queue 1, "
            "items 13-14: parallel/seq.py, whole-region encoding over several cards)")
    if _n_processes() > 1:
        raise NotImplementedError(
            "training over several processes is not ported to PyTorch yet (ROADMAP.md "
            "queue 1, item 13: DDP over NCCL)")


def uses_cell_metrics(cfg: Config) -> bool:
    """Cell metrics need ``train.use_cell_metrics`` and a slide dataframe
    (its nuclei CSVs), as in the JAX trainer."""
    return bool(cfg.select("train.use_cell_metrics")) and bool(
        cfg.select("data.slide_dataframe_path"))


def check_cell_loss(cfg: Config) -> None:
    """The cell loss pools over the nuclei masks, which the loaders return
    only with cell metrics on: raise ``ValueError`` before any work
    otherwise (the JAX trainer gets as far as its first step and fails
    there on the missing ``"nuclei"``)."""
    if cfg.select("train.losses.cell_loss.use_loss") and not uses_cell_metrics(cfg):
        raise ValueError(
            "train.losses.cell_loss.use_loss needs the nuclei masks, which are loaded only "
            "with train.use_cell_metrics true and a data.slide_dataframe_path; got "
            f"train.use_cell_metrics={cfg.select('train.use_cell_metrics')!r}, "
            f"data.slide_dataframe_path={cfg.select('data.slide_dataframe_path')!r}")


def cell_metric_keys(split: str, cm: Dict, marker_cols) -> Dict[str, float]:
    """The logged cell metrics of one split (the JAX trainer's keys)."""
    out = {f"{split}_cell_{key}": float(cm[key]) for key in METRIC_KEYS}
    for marker_col in marker_cols:
        for key in METRIC_KEYS:
            if f"{marker_col}_{key}" in cm:
                out[f"{split}_cell_{key}_{marker_col}"] = float(cm[f"{marker_col}_{key}"])
    return out


def get_width_height(dataframe: Table) -> tuple:
    if "image_path" not in dataframe.columns:
        return int(dataframe["tile_size_x"][0]), int(dataframe["tile_size_y"][0])
    from ..slideio import read_image

    sample = read_image(dataframe["image_path"][0])
    return sample.shape[1], sample.shape[0]


def swap_augmentation_replicas(dataframe: Table, augmentation_dir: str, prob: float,
                               rng) -> Table:
    """CycleGAN-normalized replica swap: with probability ``prob`` a tile's
    image_path points at its stain-normalized copy for this epoch
    (reference: src/callbacks.py:152-224, wired at src/train.py:195-199)."""
    paths = dataframe["image_path"].copy()
    aug_dir = Path(augmentation_dir)
    mask = rng.random(len(dataframe)) < prob
    for idx in np.flatnonzero(mask):
        cand = aug_dir / Path(paths[idx]).name
        if cand.exists():
            paths[idx] = str(cand)
    return dataframe.replace("image_path", paths)


def train_patchgan(cfg: Config, logdir: str, dtype: Optional[str] = None,
                   max_steps_per_epoch: Optional[int] = None, use_wandb: bool = True,
                   resume: bool = False, device=None) -> Dict:
    """Train the generator of ``cfg`` into ``logdir``; returns
    ``{"history", "best", "state"}`` (and ``"preempted": True`` after a
    SIGTERM). ``dtype`` is the frozen encoder's ("bfloat16" by default on
    the card, "float32" on the CPU); ``resume`` continues from the newest
    snapshot in ``<logdir>/snapshots``."""
    refuse_unported(cfg)
    check_cell_loss(cfg)
    device = resolve_device(device)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    if dtype is None:
        dtype = "bfloat16" if device.type == "cuda" else "float32"

    train_df = Table.read_csv(cfg.data.train_dataframe_path)
    val_df = Table.read_csv(cfg.data.val_dataframe_path)
    test_df = Table.read_csv(cfg.data.test_dataframe_path)
    log.info("%d train / %d val / %d test tiles", len(train_df), len(val_df), len(test_df))
    from_slide = "image_path" not in train_df.columns
    slide_df = (Table.read_csv(cfg.data.slide_dataframe_path)
                if cfg.data.slide_dataframe_path else None)
    channel_stats = load_channel_stats(cfg.data.channel_stats_path)

    width, height = get_width_height(train_df)
    width, height = get_effective_width_height(width, height, train=True)
    channel_names = list(cfg.data.targ_channel_names)
    nc_out = len(channel_names)
    targ_idxs = channel_stats.channel_idxs(channel_names)
    encoder_name = cfg.select("model.encoder.encoder_name", "hoptimus0")

    he_norm = Normalizer(get_input_mean_std(cfg.model.model_name, encoder_name,
                                            channel_stats.rgb), mode="he")
    if_norm = Normalizer(mode="if")

    sampler_cfg = cfg.train.data_sampler
    sampler = None
    if sampler_cfg.use_sampler:
        sampler = BalancedPositiveSampler(train_df, channel_names, sampler_cfg.tresh,
                                          other_percent=sampler_cfg.other_percent)
        # the JAX trainer draws one sampler epoch for its initialisation
        # batch; drawing it here too keeps both trainers' epochs the same
        sampler.epoch_indices()

    use_cell_metrics = uses_cell_metrics(cfg)
    dm = DataModule(
        slide_dataframe=slide_df, train_dataframe=train_df, val_dataframe=val_df,
        test_dataframe=test_df, targ_channel_idxs=targ_idxs, batch_size=cfg.train.batch_size,
        input_shape=(width, height), from_slide=from_slide, return_nuclei=use_cell_metrics,
        train_sampler=sampler, preprocess_input_fn=he_norm, preprocess_target_fn=if_norm,
        seed=cfg.train.seed)
    dm.setup()

    torch.manual_seed(cfg.train.seed)    # fresh generator weights and the discriminator's
    if cfg.model.checkpoint_path:
        model = load_generator(
            cfg.model.model_name, encoder_name, Path(cfg.model.checkpoint_path).parent,
            (height, width), nc_out, dtype=torch.float32, device=device,
            encoder_ckpt_path=cfg.select("model.encoder.encoder_weights"), fast_heads=False)
    else:
        model = get_generator(cfg.model.model_name, width, nc_out, encoder_name,
                              dtype=torch.float32, device=device)

    loss_reconstruct = build_reconstruction_loss(
        cfg, channel_names, channel_stats,
        train_dataframe=train_df if cfg.train.losses.use_weighted_mae else None)

    cell_loss_cfg = cfg.train.losses.cell_loss
    cell_loss_fn = None
    if cell_loss_cfg.use_loss:
        cell_loss_fn = build_cell_loss(
            cell_loss_cfg.mlp_path, nc_out, use_mse=cell_loss_cfg.use_mse,
            use_clustering=cell_loss_cfg.use_clustering,
            lambda_factor=cfg.train.losses.lambda_factor, device=device)

    gan_train = bool(cfg.train.gan_train)
    disc = None
    if gan_train:
        selected = None
        if cfg.train.gan_mode in ("structural", "stuctural"):
            mask = channel_stats.structural_mask(channel_names)
            selected = [i for i, m in enumerate(mask) if m]
        disc = DiscriminatorPatch(3 + (nc_out if selected is None else len(selected)),
                                  selected_channels=selected)

    batch_size = cfg.train.batch_size
    steps_per_epoch = len(train_df) // batch_size
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    accum = max(int(cfg.select("train.grad_accum_steps", 1) or 1), 1)
    # schedules count optimizer steps: with accumulation, k microbatch steps
    # advance the pix2pix schedule once
    total_iters = max(steps_per_epoch * cfg.train.epochs // accum, 1)
    # sqrt-batch LR scaling on the effective batch (reference
    # src/train.py:163-164 at the optimizer-step granularity)
    lr_g = scaled_lr(cfg.train.learning_rate_g, batch_size * accum)
    lr_d = scaled_lr(cfg.train.learning_rate_d, batch_size * accum)
    gen_opt = build_generator_optimizer(lr_g, total_iters, grad_accum_steps=accum)
    disc_opt = build_discriminator_optimizer(lr_d, total_iters,
                                             grad_accum_steps=accum) if gan_train else None

    cell_metrics = CellMetrics(slide_df, channel_names) if use_cell_metrics else None

    step_cfg = StepConfig(gan_train=gan_train,
                          lsgan=cfg.select("train.losses.adversarial_loss") == "lsgan",
                          use_cell_loss=cell_loss_fn is not None)
    state = create_train_state(
        model, gen_opt, disc, disc_opt, freeze_model_name=cfg.model.model_name,
        frozen_dtype=torch.bfloat16 if dtype == "bfloat16" else None, seed=cfg.train.seed,
        device=device)

    snapshots = logdir / "snapshots"
    start_epoch = 0
    if resume:
        ckpt = latest_checkpoint(snapshots)
        if ckpt:
            restore_train_state(ckpt, state)
            start_epoch = state.step // max(steps_per_epoch, 1)
            log.info("resumed from %s at step %d (epoch %d)", ckpt, state.step, start_epoch)

    train_step = make_train_step(model, loss_reconstruct, gen_opt, disc, disc_opt, step_cfg,
                                 cell_loss_fn=cell_loss_fn)
    eval_step = make_eval_step(model, loss_reconstruct, step_cfg)

    save_config(cfg, logdir / "config.yaml")
    logger = MetricsLogger(str(logdir), project=cfg.train.wandb_project, run_name=logdir.name,
                           config=cfg.to_dict(), use_wandb=use_wandb)

    monitor = cfg.train.callbacks.modelcheckpoint.monitor
    mode = cfg.train.callbacks.modelcheckpoint.mode
    best = -np.inf if mode == "max" else np.inf
    logreg_head = None
    history = []
    aug_rng = np.random.default_rng(cfg.train.seed)

    # Graceful preemption: the handler only sets a flag; the step loop
    # snapshots the full train state at the next step boundary, writes
    # status.txt=preempted, and returns, so ``run --resume=<logdir>``
    # continues mid-run.
    preempt = {"sig": None}
    prev_handlers = {}

    def on_preempt(signum, frame):
        preempt["sig"] = signum
        log.warning("signal %d received: snapshotting at the next step boundary", signum)

    try:
        prev_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, on_preempt)
    except ValueError:
        pass    # not the main thread (e.g. driven from a test harness)

    try:

        def run_eval(split: str, epoch: int) -> Dict:
            nonlocal logreg_head
            metrics = PixelMetrics.zeros(device)
            losses = []
            loader = dm.loader(split, epoch=epoch)
            loader.pad_to_batch = True    # fixed shapes; the mask keeps the metrics exact
            for batch in device_prefetch(loader, size=2, device=device):
                b = {"image": batch["image"], "target": batch["target"], "mask": batch["mask"]}
                metrics, elog = eval_step(state, b, metrics)
                losses.append(elog["gen_loss_sim"])
                if cell_metrics is not None:
                    n_valid = int(batch["mask"].sum())
                    cell_metrics.update(elog["pred"][:n_valid], batch["nuclei"][:n_valid],
                                        batch["slide_name"][:n_valid])
            out = {f"{split}_{k}": float(v) for k, v in metrics.compute().items()}
            out[f"{split}_gen_loss_sim"] = (float(np.mean([float(v) for v in losses]))
                                            if losses else np.nan)
            if cell_metrics is not None:
                cm = cell_metrics.compute(logreg_head=logreg_head if split == "test" else None)
                if split == "val":
                    logreg_head = cm["logreg_head"]
                out.update(cell_metric_keys(split, cm, cell_metrics.marker_cols))
            return out

        def export_checkpoint(tag: str):
            save_train_state(state, snapshots)
            save_generator(model, logdir / f"{tag}.safetensors")

        global_step = state.step
        for epoch in range(start_epoch, cfg.train.epochs):
            if cfg.data.augmentation_dir and not from_slide:
                dm.frames["train"] = swap_augmentation_replicas(
                    train_df, cfg.data.augmentation_dir, 0.25, aug_rng)
                dm.setup()
            train_metrics = PixelMetrics.zeros(device)
            loader = dm.loader("train", epoch=epoch)
            # the step scalars and NaN flags stay on the card; one fetch
            # every LOG_EVERY steps and at the epoch's end
            sums: Optional[Dict] = None
            last: Optional[Dict] = None
            nan_step = None     # the first step with a NaN output, or _NO_NAN
            count = 0

            def sync_and_check_nan() -> Dict:
                """One fetch: the latest scalars and the first NaN step
                since the epoch began; dumps and raises on a NaN."""
                if last is None:
                    return {}
                first, *values = torch.stack(
                    [nan_step.double()] + [v.double() for v in last.values()]).tolist()
                if first != _NO_NAN:
                    export_checkpoint("weights_nan")
                    (logdir / "weights_nan.step").write_text(f"{int(first)}\n")
                    raise ValueError(f"Nan found (first at step {int(first)})")  # models.py:105
                return dict(zip(last, values))

            for i, batch in enumerate(device_prefetch(loader, size=2, device=device)):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                if preempt["sig"] is not None:
                    break
                b = {"image": batch["image"], "target": batch["target"]}
                if step_cfg.use_cell_loss:
                    b["nuclei"] = batch["nuclei"]
                state, train_metrics, slog = train_step(state, b, train_metrics)
                global_step += 1
                scalars = {k: v for k, v in slog.items() if k not in ("nan", "grads")}
                step_if_nan = torch.where(slog["nan"], global_step, _NO_NAN)
                last = scalars
                count += 1
                if sums is None:
                    sums, nan_step = dict(scalars), step_if_nan
                else:
                    sums = {k: sums[k] + v for k, v in scalars.items()}
                    nan_step = torch.minimum(nan_step, step_if_nan)
                if global_step % LOG_EVERY == 0:
                    logger.log(sync_and_check_nan(), step=global_step)
                if global_step % 1000 == 1:
                    pred = eval_step(state, b, PixelMetrics.zeros(device))[1]["pred"]
                    save_image_grid(str(logdir / "logs_img" / f"step{global_step}.png"),
                                    he_norm.unormalize(b["image"].cpu().numpy()),
                                    pred.float().cpu().numpy(), b["target"].cpu().numpy())
            sync_and_check_nan()    # the epoch's NaN check and drain
            if preempt["sig"] is not None:
                save_train_state(state, snapshots)
                (logdir / "status.txt").write_text("preempted")
                log.warning("preempted at step %d: resume with run --resume=%s",
                            state.step, logdir)
                logger.finish()
                return {"history": history, "best": best, "state": state, "preempted": True}
            epoch_metrics = {f"train_{k}": float(v) for k, v in train_metrics.compute().items()}
            if sums is not None:
                epoch_metrics.update({k: float(v) / count for k, v in sums.items()})
            epoch_metrics.update(loader.stats.snapshot())
            epoch_metrics.update(run_eval("val", epoch))
            epoch_metrics["epoch"] = epoch
            logger.log(epoch_metrics, step=global_step)
            history.append(epoch_metrics)
            log.info("epoch %d: %s", epoch, {k: round(v, 4) for k, v in epoch_metrics.items()
                                            if isinstance(v, float)})

            score = epoch_metrics.get(monitor)
            if score is not None and ((mode == "max" and score > best)
                                      or (mode == "min" and score < best)):
                best = score
                export_checkpoint("model")
                log.info("new best %s=%.4f -> checkpoint saved", monitor, best)

        test_metrics = run_eval("test", cfg.train.epochs)
        logger.log(test_metrics, step=global_step)
        history.append(test_metrics)
        (logdir / "status.txt").write_text("finished")   # reference: run.py:38-45
        logger.finish()
        return {"history": history, "best": best, "state": state}
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
