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

Every generator family the port builds trains here: the flagship, the
UNETR on a ViT or on ResNet-50 and the SMP U-Net (with
``train.foreground_head``, its foreground term). As in the JAX trainer, a
fully trainable ``unet`` encoder takes the 0.65 layer-wise LR decay, and
``model.dropout`` reaches the generators that have dropout. The export is
the port's own state dict, the reference layout, for every family (the JAX
trainer writes a flattened flax layout for the non-flagship ones).

Runs on the card unless ``device="cpu"`` is given (without a card it
raises), computing in bf16 on the card with the frozen weights stored in
bf16 (the flagship's foundation encoder) and the trainable ones in f32, and
in f32 on the CPU.

Over several processes (torchrun; ``parallel.init_distributed`` has started
the group, and ``WORLD_SIZE > 1`` without one raises), the ranks form an
``n_data x n_model`` mesh: ``n_model`` is ``train.mesh.num_model_shards``
with ``model.attn_impl=seq_shard`` (the flagship's ViT tokens sharded over
a model group, ``parallel/seq.py``), else 1. Each rank loads
``train.batch_size`` rows of its data coordinate's shard of the epoch, so
the global batch, the steps per epoch, the sqrt-batch learning rate and
the resume arithmetic count ``batch_size x n_data``, as the JAX trainer's
multi-host units do; every rank runs the smallest shard's batch count. The
step reduces the gradients and the BatchNorm statistics (``train/steps.py``).
The step scalars, the NaN flag and the preemption flag are reduced at the
fetch points (every ``LOG_EVERY`` steps and at the epoch's end), so a
SIGTERM on one rank makes every rank snapshot at the same step boundary.
Validation and test shard their tiles over the data ranks too; the pixel
sums are summed over them and the cell tables gathered to rank 0, so the
logged metrics are those of the whole split. Rank 0 alone writes: the
config, metrics, images (one process only, as in the JAX trainer),
snapshots, the export and ``status.txt``.
"""

from __future__ import annotations

import contextlib
import logging
import signal
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

import torch.distributed as dist

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
from ..models.layers import set_compute_dtype
from ..models.vit import set_attn_impl
from ..parallel.mesh import Mesh, make_mesh, process_device, require_process_group
from ..parallel.seq import seq_shard_scope
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


def model_shards(cfg: Config, n_proc: int) -> int:
    """The model group's size: ``train.mesh.num_model_shards`` with
    ``model.attn_impl=seq_shard``, else 1. Raises ``ValueError`` before any
    work where the JAX trainer's check would (fewer than 2 shards, more than
    the ranks), where the shards do not divide the ranks, and for a
    generator without the flagship's ViT encoder. ``train.mesh.model_axis``
    (tensor parallelism) has no effect on the trainer, whose run is the
    one without it, as in the JAX trainer, which never reads the key; a log
    line says so."""
    if cfg.select("train.mesh.model_axis"):
        log.warning("train.mesh.model_axis=%r has no effect on the trainer (it does not "
                    "tensor-shard the encoder, as the JAX trainer does not)",
                    cfg.select("train.mesh.model_axis"))
    if cfg.select("model.attn_impl", "auto") != "seq_shard":
        return 1
    n_model = int(cfg.select("train.mesh.num_model_shards", 1) or 1)
    if n_model < 2 or n_model > n_proc:
        raise ValueError(
            f"model.attn_impl=seq_shard needs train.mesh.num_model_shards in [2, {n_proc}] "
            f"(sequence shards must span >= 2 ranks and fit the {n_proc} ranks); got "
            f"{n_model}. Launch {n_model} or more ranks through torchrun and set "
            "train.mesh.num_model_shards explicitly, or use attn_impl=auto for one rank's "
            "attention.")
    if n_proc % n_model:
        raise ValueError(f"train.mesh.num_model_shards={n_model} does not divide the "
                         f"{n_proc} ranks")
    if not cfg.model.model_name.startswith("myvitmatte"):
        raise ValueError(f"model.attn_impl=seq_shard shards the flagship's ViT encoder "
                         f"(myvitmatte), not {cfg.model.model_name!r}")
    return n_model


class _NullLogger:
    """The logger of every rank but 0."""

    def log(self, metrics: Dict, step: Optional[int] = None):
        pass

    def finish(self):
        pass


class _StepTrace:
    """``train_patchgan(profile_steps=n)``: a ``torch.profiler`` trace of the
    train steps from global step 2 to 2 + n, exported as a gzipped Chrome
    trace into ``out_dir`` (``path`` once written)."""

    START = 2

    def __init__(self, steps: int, out_dir: Path, device: torch.device):
        self.steps, self.out_dir, self.device = int(steps), out_dir, device
        self.prof, self.first, self.path = None, None, None

    def before(self, global_step: int) -> None:
        if self.steps > 0 and self.prof is None and self.path is None \
                and global_step == self.START:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof, self.first = profile(activities=acts), global_step
            self.prof.start()

    def after(self, global_step: int) -> None:
        if self.prof is not None and global_step == self.START + self.steps:
            self.stop(global_step)

    def stop(self, global_step: int) -> None:
        """Ends the trace (at its last step, or when training ends first)."""
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"trace_steps{self.first}-{global_step}.json.gz"
        prof.export_chrome_trace(str(path))
        self.path = str(path)
        log.info("profiler trace -> %s", path)


def _reduce(values: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """``values`` reduced over ``group`` (sum unless ``op``), a copy."""
    values = values.clone()
    dist.all_reduce(values, op=op or dist.ReduceOp.SUM, group=group)
    return values


def _reduce_pixel_metrics(metrics: PixelMetrics, mesh: Optional[Mesh]) -> PixelMetrics:
    """The pixel sums of every data rank's rows (a model group's ranks hold
    the same rows and count once)."""
    if mesh is None or mesh.n_data == 1:
        return metrics
    sums = _reduce(torch.stack([metrics.sse, metrics.count, metrics.ssim_sum, metrics.images]),
                   group=mesh.data_group)
    return PixelMetrics(*sums.unbind())


def _gather_cell_tables(cell_metrics: CellMetrics, mesh: Optional[Mesh]) -> None:
    """Rank 0's cell tables extended by those of every data rank (a model
    group's ranks hold the same cells: its rank 0 alone sends)."""
    if mesh is None or mesh.n_data == 1 or mesh.model_rank != 0:
        return
    gathered = [None] * mesh.n_data if dist.get_rank() == 0 else None
    dist.gather_object(cell_metrics._acc, gathered, dst=0, group=mesh.data_group)
    if gathered is not None:
        cell_metrics._acc = {name: [t for acc in gathered for t in acc[name]]
                             for name in cell_metrics._acc}


def uses_cell_metrics(cfg: Config) -> bool:
    """Cell metrics need ``train.use_cell_metrics`` and a slide dataframe
    (its nuclei CSVs), as in the JAX trainer."""
    return bool(cfg.select("train.use_cell_metrics")) and bool(
        cfg.select("data.slide_dataframe_path"))


def check_foreground_head(cfg: Config) -> None:
    """``train.foreground_head`` needs a generator with a foreground head,
    which only the SMP U-Net has: raise ``ValueError`` before any work
    otherwise (the JAX train step would unpack the masks' batch axis as
    ``(masks, fg_logits)``)."""
    name = cfg.model.model_name
    if cfg.select("train.foreground_head") and not name.startswith("smp_unet"):
        raise ValueError(f"train.foreground_head needs a generator with a foreground head "
                         f"(smp_unet), not {name!r}")


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
                   resume: bool = False, device=None, profile_steps: int = 0) -> Dict:
    """Train the generator of ``cfg`` into ``logdir``; returns
    ``{"history", "best", "state"}`` (and ``"preempted": True`` after a
    SIGTERM; ``"profile"``, the trace's path, after a profiled run).
    ``dtype`` is the compute dtype and the frozen weights' ("bfloat16" by
    default on the card, "float32" on the CPU); ``resume`` continues from
    the newest snapshot in ``<logdir>/snapshots``. Under a process group the
    device defaults to the rank's (``parallel.init_distributed``'s).

    ``profile_steps`` > 0 traces that many train steps from global step 2
    (the counterpart of the JAX trainer's ``jax.profiler`` trace) with
    ``torch.profiler`` (CPU and, on the card, CUDA activities) into
    ``<logdir>/profile/trace_steps{a}-{b}.json.gz``, on rank 0 only under a
    process group; the device is synchronised before the trace stops.
    Training is otherwise unchanged."""
    check_foreground_head(cfg)
    check_cell_loss(cfg)
    n_proc = require_process_group()
    n_model = model_shards(cfg, n_proc)
    seq_shard = cfg.select("model.attn_impl", "auto") == "seq_shard"
    device = resolve_device(device if device is not None else process_device())
    mesh = make_mesh(n_proc // n_model, n_model) if n_proc > 1 else None
    n_data = mesh.n_data if mesh is not None else 1
    is_main = mesh is None or dist.get_rank() == 0
    logdir = Path(logdir)
    if is_main:
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
    dropout = float(cfg.select("model.dropout", 0.0) or 0.0)
    foreground_head = bool(cfg.select("train.foreground_head", False))
    if cfg.model.checkpoint_path:
        model = load_generator(
            cfg.model.model_name, encoder_name, Path(cfg.model.checkpoint_path).parent,
            (height, width), nc_out, dtype=torch.float32, device=device,
            encoder_ckpt_path=cfg.select("model.encoder.encoder_weights"), fast_heads=False,
            dropout=dropout)
    else:
        model = get_generator(cfg.model.model_name, width, nc_out, encoder_name,
                              dtype=torch.float32, device=device, dropout=dropout,
                              foreground_head=foreground_head)
    # f32 parameters, bf16 compute on the card (the JAX trainer's
    # get_generator(dtype=...)); the frozen ones are stored in bf16 below
    set_compute_dtype(model, torch.bfloat16 if dtype == "bfloat16" else None)
    if seq_shard:
        set_attn_impl(model, "seq_shard")

    loss_reconstruct = build_reconstruction_loss(
        cfg, channel_names, channel_stats,
        train_dataframe=train_df if cfg.train.losses.use_weighted_mae else None)

    cell_loss_cfg = cfg.train.losses.cell_loss
    cell_loss_fn = None
    if cell_loss_cfg.use_loss:
        cell_loss_fn = build_cell_loss(
            cell_loss_cfg.mlp_path, nc_out, use_mse=cell_loss_cfg.use_mse,
            use_clustering=cell_loss_cfg.use_clustering,
            lambda_factor=cfg.train.losses.lambda_factor, device=device,
            group=mesh.data_group if n_data > 1 else None)

    gan_train = bool(cfg.train.gan_train)
    disc = None
    if gan_train:
        selected = None
        if cfg.train.gan_mode in ("structural", "stuctural"):
            mask = channel_stats.structural_mask(channel_names)
            selected = [i for i, m in enumerate(mask) if m]
        disc = DiscriminatorPatch(3 + (nc_out if selected is None else len(selected)),
                                  selected_channels=selected)

    # each rank loads batch_size rows of its data shard: every step consumes
    # batch_size x n_data samples, and the schedule, the sqrt-batch LR and
    # the resume epoch count in those units (the JAX trainer's global_bs)
    batch_size = cfg.train.batch_size
    global_bs = batch_size * n_data
    steps_per_epoch = len(train_df) // global_bs
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    accum = max(int(cfg.select("train.grad_accum_steps", 1) or 1), 1)
    # schedules count optimizer steps: with accumulation, k microbatch steps
    # advance the pix2pix schedule once
    total_iters = max(steps_per_epoch * cfg.train.epochs // accum, 1)
    # sqrt-batch LR scaling on the effective batch (reference
    # src/train.py:163-164 at the optimizer-step granularity)
    lr_g = scaled_lr(cfg.train.learning_rate_g, global_bs * accum)
    lr_d = scaled_lr(cfg.train.learning_rate_d, global_bs * accum)
    # the layer decay of fully trainable ViT encoders, over 40 layers whatever
    # the depth, as the JAX trainer builds it (trainer.py:197-201)
    model_name = cfg.model.model_name
    vit_lr_decay = (model_name.startswith("unet") and "lora" not in model_name
                    and "frozen" not in model_name)
    gen_opt = build_generator_optimizer(lr_g, total_iters, grad_accum_steps=accum,
                                        vit_lr_decay=vit_lr_decay)
    disc_opt = build_discriminator_optimizer(lr_d, total_iters,
                                             grad_accum_steps=accum) if gan_train else None

    cell_metrics = CellMetrics(slide_df, channel_names) if use_cell_metrics else None

    step_cfg = StepConfig(gan_train=gan_train,
                          lsgan=cfg.select("train.losses.adversarial_loss") == "lsgan",
                          foreground_head=foreground_head,
                          use_cell_loss=cell_loss_fn is not None)
    state = create_train_state(
        model, gen_opt, disc, disc_opt, freeze_model_name=cfg.model.model_name,
        frozen_dtype=torch.bfloat16 if dtype == "bfloat16" else None, seed=cfg.train.seed,
        device=device, mesh=mesh)

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

    if is_main:
        save_config(cfg, logdir / "config.yaml")
        logger = MetricsLogger(str(logdir), project=cfg.train.wandb_project,
                               run_name=logdir.name, config=cfg.to_dict(), use_wandb=use_wandb)
    else:
        logger = _NullLogger()

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

    def preempt_agreed() -> bool:
        """Ranks leave the step loop together: a rank that broke alone would
        leave the others waiting in a collective. The flag is reduced at the
        fetch points only."""
        local = preempt["sig"] is not None
        if mesh is None:
            return local
        return bool(_reduce(torch.tensor([float(local)], device=device),
                            dist.ReduceOp.MAX).item())

    # every forward of the run shards its ViT tokens over the model group
    scope = seq_shard_scope(mesh) if seq_shard else contextlib.nullcontext()
    trace = _StepTrace(profile_steps if is_main else 0, logdir / "profile", device)
    global_step = state.step
    scope.__enter__()
    try:

        def run_eval(split: str, epoch: int) -> Dict:
            nonlocal logreg_head
            metrics = PixelMetrics.zeros(device)
            losses = []
            loader = dm.loader(split, epoch=epoch)
            loader.pad_to_batch = True    # fixed shapes; the mask keeps the metrics exact
            if n_data > 1:
                loader.shard(mesh.data_rank, n_data)
            for batch in device_prefetch(loader, size=2, device=device):
                b = {"image": batch["image"], "target": batch["target"], "mask": batch["mask"]}
                metrics, elog = eval_step(state, b, metrics)
                losses.append(elog["gen_loss_sim"])
                if cell_metrics is not None:
                    n_valid = int(batch["mask"].sum())
                    cell_metrics.update(elog["pred"][:n_valid], batch["nuclei"][:n_valid],
                                        batch["slide_name"][:n_valid])
            metrics = _reduce_pixel_metrics(metrics, mesh)
            out = {f"{split}_{k}": float(v) for k, v in metrics.compute().items()}
            # the mean over every data rank's batches
            loss_sum = torch.stack([torch.stack(losses).float().sum() if losses
                                    else torch.zeros((), device=device),
                                    torch.tensor(float(len(losses)), device=device)])
            if n_data > 1:
                loss_sum = _reduce(loss_sum, group=mesh.data_group)
            total, n_batches = loss_sum.tolist()
            out[f"{split}_gen_loss_sim"] = total / n_batches if n_batches else np.nan
            if cell_metrics is not None:
                _gather_cell_tables(cell_metrics, mesh)
                if is_main:
                    cm = cell_metrics.compute(
                        logreg_head=logreg_head if split == "test" else None)
                    if split == "val":
                        logreg_head = cm["logreg_head"]
                    out.update(cell_metric_keys(split, cm, cell_metrics.marker_cols))
                else:
                    cell_metrics.reset()
            return out

        def export_checkpoint(tag: str):
            if is_main:
                save_train_state(state, snapshots)
                save_generator(model, logdir / f"{tag}.safetensors")

        for epoch in range(start_epoch, cfg.train.epochs):
            if cfg.data.augmentation_dir and not from_slide:
                dm.frames["train"] = swap_augmentation_replicas(
                    train_df, cfg.data.augmentation_dir, 0.25, aug_rng)
                dm.setup()
            train_metrics = PixelMetrics.zeros(device)
            loader = dm.loader("train", epoch=epoch)
            rank_cap = None
            if n_data > 1:
                # each data rank walks its shard of the epoch; shards can
                # differ by a sample, so every rank runs the smallest one's
                # batch count (the ranks must take the same steps)
                loader.shard(mesh.data_rank, n_data)
                rank_cap = (len(train_df) // n_data) // batch_size
            # the step scalars and NaN flags stay on the card; one fetch
            # every LOG_EVERY steps and at the epoch's end
            sums: Optional[Dict] = None
            last: Optional[Dict] = None
            nan_step = None     # the first step with a NaN output, or _NO_NAN
            count = 0

            def sync_and_check_nan() -> Dict:
                """One fetch: the latest scalars (their mean over the
                ranks) and the first NaN step since the epoch began (over
                every rank); dumps and raises on a NaN."""
                if last is None:
                    return {}
                packed = torch.stack([v.double() for v in last.values()])
                first = nan_step.double()
                if mesh is not None:
                    packed = _reduce(packed) / mesh.size
                    first = _reduce(first, dist.ReduceOp.MIN)
                first, *values = torch.cat([first.reshape(1), packed]).tolist()
                if first != _NO_NAN:
                    export_checkpoint("weights_nan")
                    if is_main:
                        (logdir / "weights_nan.step").write_text(f"{int(first)}\n")
                    raise ValueError(f"Nan found (first at step {int(first)})")  # models.py:105
                return dict(zip(last, values))

            for i, batch in enumerate(device_prefetch(loader, size=2, device=device)):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                if rank_cap is not None and i >= rank_cap:
                    break
                if mesh is None and preempt["sig"] is not None:
                    break
                b = {"image": batch["image"], "target": batch["target"]}
                if step_cfg.use_cell_loss:
                    b["nuclei"] = batch["nuclei"]
                trace.before(global_step)
                state, train_metrics, slog = train_step(state, b, train_metrics)
                global_step += 1
                trace.after(global_step)
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
                    if mesh is not None and preempt_agreed():
                        break
                if global_step % 1000 == 1 and mesh is None:
                    # the debug grid: one process only (a sequence-sharded
                    # forward needs its whole model group)
                    pred = eval_step(state, b, PixelMetrics.zeros(device))[1]["pred"]
                    save_image_grid(str(logdir / "logs_img" / f"step{global_step}.png"),
                                    he_norm.unormalize(b["image"].cpu().numpy()),
                                    pred.float().cpu().numpy(), b["target"].cpu().numpy())
            sync_and_check_nan()    # the epoch's NaN check and drain
            if preempt_agreed():
                if is_main:
                    save_train_state(state, snapshots)
                    (logdir / "status.txt").write_text("preempted")
                log.warning("preempted at step %d: resume with run --resume=%s",
                            state.step, logdir)
                logger.finish()
                return {"history": history, "best": best, "state": state, "preempted": True}
            train_metrics = _reduce_pixel_metrics(train_metrics, mesh)
            epoch_metrics = {f"train_{k}": float(v) for k, v in train_metrics.compute().items()}
            if sums is not None:
                means = torch.stack([v.double() for v in sums.values()]) / count
                if mesh is not None:
                    means = _reduce(means) / mesh.size
                epoch_metrics.update(dict(zip(sums, means.tolist())))
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
        if is_main:
            (logdir / "status.txt").write_text("finished")   # reference: run.py:38-45
        logger.finish()
        out = {"history": history, "best": best, "state": state}
        if trace.path is not None:
            out["profile"] = trace.path
        return out
    finally:
        trace.stop(global_step)
        scope.__exit__(None, None, None)
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
