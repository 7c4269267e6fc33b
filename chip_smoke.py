"""Smoke run of the PyTorch port (mipheivit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 attention and K6 short-sequence
attention over [B, H, S, D], K4 long-sequence flash attention, K5 its
backward, K2 the fused SwiGLU fc1 with a second entry point for its
backward's elementwise terms and a third, K7, the fused LayerNorm + matmul,
K3 the fused marker heads, K8 the fused attention sublayer) from
mipheivit_tpu_torch/csrc, one nvcc per source, all at once; holds each
against its plain PyTorch version at the shapes the paths give it,
then drives the port's paths at full width from a reference-layout
MIPHEI-ViT checkpoint dir (H-Optimus-0 ViT-g/14 encoder, 16 markers, random
weights from a numpy seed). Serving: load_generator(fast_heads=True) ->
merge_lora -> cast_params(bf16); every encoder block runs K2 and every eval
forward ends in K3:

  [slice]      predict_tiles on 150 uint8 256-px tiles at batch 64 (K1);
  [serve]      the daemon: build_serving_fn (batch 32, the CLI's default)
               behind a TileServer on 127.0.0.1, 16 client threads POSTing
               256 single tiles (K1);
  [wsi 256]    wsi_inference over a synthetic 2048 x 2048 slide, 256-px
               windows, overlap 64, batch 64 (121 windows; K1);
  [wsi 1024]   the same with 1024-px region windows, overlap 128, batch 4
               (9 windows, S = 5334 tokens; K4);
  [attn sublayer] block 0 of the same generator on the tokens of 64 tiles:
               the attention sublayer before proj three ways, the model's
               norm1 -> qkv -> attention_qkv (K1), ln_matmul ->
               attention_qkv (K7 + K1) and ln_qkv_attention (K8), each held
               against the f32 plain chain.

int8 W8A8 serving (ops/quant.py: torch._int_mm, cuBLASLt's int8 product, a
library call; quantise and dequantise passes in PyTorch; fc1 is an int8
product, so K2 does not run):

  [int8 ops]   int8_matmul at the flagship's four GEMMs at 64 tiles (M 21 056:
               qkv, proj, fc1, fc2) and at M 9, int8_conv3x3 at the four
               fusion blocks of 64 tiles, each against its plain version on
               the CPU (weight and activation codes identical, the output
               within one bf16 step), timed beside F.linear / cuDNN conv2d in
               bf16 and _int_mm alone;
  [throughput int8] the flagship loaded as run_inference --int8 loads it
               (load_serving_model -> quantize_encoder -> quantize_decoder):
               tiles/s of the forward at batch 64 beside [throughput]'s, peak
               memory beside bf16's, the device time by op family (profiler),
               per-marker Pearson against the bf16 forward (K1, K3);
  [wsi 256 int8], [wsi 1024 int8] wsi_inference over the 2048^2 slide with
               the int8 generator (K1; K4 at 1024 px), against the serial
               stitch and, by per-marker Pearson, the bf16 slide;
  [seq shard int8] (with the multi-card phases) [seq shard wsi 1024]'s
               sharded generator in int8 over the slide's top-left 1920^2
               (2 x 2 windows of 1024 px), against the float sharded serial
               stitch and the same int8 generator's unsharded serial stitch
               (K4 on every rank).

Training: load_generator(fast_heads=False) with LoRA live ->
train.create_train_state(frozen encoder stored bf16) -> make_train_step
(weighted MSE, lambda 50; Adam chain with clip 1.0; microbatches of
accumulation 2; the generator step of the flagship preset, gan_train off):

  [train 256]  256-px tiles, microbatch 8, 3 optimizer steps (K1 forward,
               plain recompute backward; K2 forward, cuBLAS recompute
               backward with K2's backward terms);
  [train 1024] 1024-px regions, microbatch 1, 2 optimizer steps (K4
               forward, K5 backward; K2 as above);
  [train 1024 ckpt] the same with each encoder block recomputed in the
               backward (K4 and K2 launch twice per block and microbatch);
  [train ops]  one bf16 forward and backward through each of
               dot_product_attention (K6), ln_matmul (K7) and
               ln_qkv_attention (K8) at the profiling shapes, and at a small
               slice held in cosine against the f32 backward on the CPU.

The training driver: the flagship preset (as config.compose resolves it,
held as a dict here) with the same checkpoint dir, on 48 train, 16 val and
16 test tiles of 256 px written from a numpy seed:

  [trainer]    train_patchgan for 1 epoch of 4 microbatches of 8, then
               again with resume=True to epoch 2 (the data pipeline with
               device_prefetch, the step, val and test epochs, the step-1
               PNG grid, snapshots and the model.safetensors export; K1,
               K2 and K2's backward terms), with its steady images/s beside
               [train 256]'s, the loader's wait and decode shares and the
               snapshot write and restore seconds;
  [test driver] test_model on that run's directory (K1, K2).

The single-cell path, on the same checkpoint dir:

  [segment pool] nucleus_pool (CellMetrics' pooling; plain PyTorch, XLA in
               the JAX package) at 8 tiles of 256 px, 15 markers, ~150 disc
               nuclei a tile with int32 ids up to 2**31 - 1, capacity 2048
               and 64, against the CPU, timed at 8 and 64 tiles; the cell
               loss's forward and backward under set_sync_debug_mode("error");
  [cell trainer] train_patchgan on the flagship preset as it ships (cell
               metrics on a slide dataframe, monitor val_cell_auc / max) with
               the cell loss on (MSE + clustering, a seeded mlp.ckpt), 1 epoch
               of 4 microbatches of 8, two slides a split, on .npy tiles with int32
               nuclei (K1, K2, K2's backward terms), its images/s beside
               [trainer]'s and validation's cell-metric host seconds;
  [cell test driver] test_model on that run: test_dataframe_cell.csv;
  [eval orion], [eval immucan], [eval hemit] each evaluation script's run()
               on that run's export (the fused-heads bf16 forward: K1, K2,
               K3; HEMIT on 512-px tiles, its forward at 256 px).

The baseline generators (random weights from seeds; the UNETR checkpoint dir
foundation-stripped beside the flagship's H-Optimus-0 encoder file):

  [unetr]      the unet_lora / H-Optimus-0 preset through load_generator ->
               merge_lora -> bf16: predict_tiles on the 150 tiles at batch
               64 (K1 and K2 in bf16, 40 a batch), the steady forward's
               tiles/s, f32 card vs CPU at 4 blocks (the taps need 4; held
               absolutely, against each marker map's spread and by
               per-marker Pearson), bf16 vs f32 at 40 blocks;
  [unetr bf16 probe] one tile with the heads as drawn (before contrast_head):
               each stage's relative bf16 error, the output's spread beside
               bf16's spacing, the Pearson that the contrast heads avoid;
  [unetr provgigapath], [unetr univ2], [unetr phikonv2], [unetr sp85m]
               unet_lora on the other ViT encoders at full width and depth
               (Prov-GigaPath: patch 16, S 257, the class token's position
               embedded; univ2: 24 x 1536, 8 registers, S 333; phikonv2: 24 x
               1024, 16 heads, GELU; sp85m: 12 x 768, 12 heads, GELU): f32
               card vs CPU at 4 blocks, the bf16 forward at batch 64 (tiles/s,
               peak memory) against f32 (K1; K2 on the SwiGLU encoders, none
               on the GELU ones; [k1 bf16_univ2], [k1 bf16_phikonv2] and [k1
               bf16_sp85m] hold K1 at their shapes at batch 64);
  [smp convnext] smp_unet on ConvNeXt-L with the foreground head, batch 16:
               the bf16 forward's tiles/s, f32 card vs CPU (TF32 off), no
               kernel of the port;
  [unet resnet50] the ResNet-50 UNETR, the same checks;
  [train unetr], [train convnext fg] two warm-up optimizer steps of the
               presets' microbatches (8 and 16; f32 parameters, bf16
               compute), the second with the foreground term, then 4 steps
               timed with CUDA events (median): every trainable tensor with a
               gradient moves, the trainable count is the JAX rule's, K1 = K2
               = K2's backward terms = 40 a microbatch on the UNETR;
  [train gan structural], [train gan full] the GAN ablation's step
               (experiments/gan/partial_gan.yaml and full_gan.yaml: unet_lora
               on H-Optimus-0 at 8, the PatchGAN discriminator with spectral
               norm on the structural markers or on all 16, its optimizer the
               trainer's): ms a step, images/s, the three losses a step,
               every generator and discriminator tensor and spectral u moved,
               K1 = K2 = K2's backward terms = 40 a microbatch in bf16;
  [numerics gan] that step f32 on the card against the CPU at 4 blocks
               (the same label-noise draws): the losses, the generator's and
               the discriminator's gradients and the spectral u; bf16 against
               f32 at 40 blocks;
  [train univ2], [train unet univ2], [train frozen], [train phikonv2],
               [train sp85m] the foundation-model and fine-tuning ablations'
               steps at their presets' microbatches (univ2.yaml: unet_lora on
               univ2 at 16; full_finetuning.yaml: unet on univ2 at 8 with the
               trainer's layer decay; frozen.yaml: unet_frozen on H-Optimus-0
               at 16; unet_lora on phikonv2 and sp85m at 8), as [train unetr];
  [trainer unetr] train_patchgan on the unetr preset as it ships (cell
               metrics, val_cell_auc) for 4 microbatches of 8 on .npy tiles,
               its export loaded back through load_generator;
  [trainer gan] the same on gan/partial_gan.yaml (no snapshot; the export
               without the foundation encoder);
  [k2 backward need_w] swiglu_fc1's backward with fc1 trainable (the
               UNETR's route) beside the frozen flagship's: device time from
               the profiler, CUDA events beside it (last of the baselines).
Then the Swin models, with no kernel of the port on their paths (K1-K8 = 0):
  [unetr ctranspath], [hemit] unet_lora on ctranspath's Swin (batch 64,
               heads through contrast_head) and the HEMIT dual-branch
               generator (batch 16): the bf16 forward's tiles/s and peak
               memory, f32 card vs CPU, bf16 vs f32 Pearson, and for HEMIT
               the top-k sets of each fusion, card vs CPU and bf16 vs f32;
  [hemit zoo]  resnet_9blocks, unet_256, swinT, swinT_old and SwinTUnet, f32
               card vs CPU each;
  [train ctranspath], [train hemit] the presets' steps as [train unetr];
  [trainer hemit] train_patchgan on the hemit preset as it ships (cell
               metrics), then test_model on its export;
  [train_hemit] the HEMIT reproduction's trainer for one epoch on .npy
               pairs, its best snapshot reloaded;
  [eval orion|immucan|hemit hemit pipeline] each HEMIT-pipeline script on a
               HEMIT-codebase checkpoint written as latest_net_G.pth.

The preprocessing that makes the training data (no kernel of the port:
convolutions and host code, K1-K8 = 0), after the Swin models:
  [tiff]       pyramids at write_pyramid's dtypes written and read back bit
               for bit by the native TIFF engine (on the system's libtiff or
               Pillow's bundled copy, which it names), level 0 also through
               Pillow's decoder;
  [cellpose]   Cellpose's CPnet at full width (2, 32, 64, 128, 256) on 64
               tiles of 224^2 in f32, channels_last: ms a batch, tiles/s,
               peak memory, held against the CPU forward on 2 tiles;
  [nuclei wsi] the CPnet fitted on the card to blob tiles (300 Adam steps),
               then wsi_nuclei_inference --backend torch --flow_averaging on
               a 2048^2 blob-DAPI TIFF at tile 1024: nuclei against the
               discs painted, wall seconds, the card's flow pass against the
               host's compute_masks;
  [he nuclei]  he_nuclei_inference on a 2048^2 H&E TIFF, rgb2hed on the card,
               against the same run on the CPU;
  [cycle gan]  the CycleGAN stain normaliser ResnetGenerator(64, 9) from a
               pix2pix checkpoint, batch 4 x 512^2 in f32, against the CPU on
               1 tile, then cycle_gan_wsi_inference on a 1536 x 1024 TIFF;
  [trainer profile] train_patchgan(profile_steps=2) on the [trainer]
               configuration: the trace's path, size and five longest device
               ops (K1, K2 and K2's backward terms, counted).

Several cards (the machine shows one: the ranks are 2 processes spawned on
it, joined over gloo, which carries CUDA tensors through the host; NCCL
refuses a duplicate GPU), at full width and depth:
  [collectives] all_gather_into_tensor, reduce_scatter_tensor and
               all_reduce of the k|v of a 1024-px block between the ranks,
               timed, and whether NCCL carries them;
  [seq shard wsi 1024] wsi_inference(seq_shard_mesh) over the 2048^2 slide
               in 1024-px windows, each window's 5334 tokens sharded over
               the ranks (K4 on 2667 query rows over the gathered keys),
               within 1 uint8 step of [wsi 1024]; K4's rectangle beside
               the square call;
  [seq shard 2048] one 2048-px region (21 321 tokens) sharded, each rank's
               peak memory, against the unsharded forward (Pearson);
  [train seq shard 1024] the generator step at 1024 px sharded (K4, K5),
               LoRA gradients against one rank's step, the reduced LoRA and
               decoder gradient norms against its, replicas identical;
  [trainer ddp] train_patchgan over the ranks at [trainer]'s global batch:
               its loss and first step's reduced gradient norms against
               [trainer]'s, replicas identical, rank 0 alone writes;
  [serve dp], [wsi dp] build_serving_fn and wsi_inference with each batch
               split over two replicas on the card (make_data_mesh),
               against one replica's answer;
  [tp forward] the serving generator tensor-parallel over the ranks
               (shard_params after merge_lora and cast_params: 12 heads
               and SwiGLU hidden 2048 a rank, proj and fc2 all-reduced):
               one batch of 16 tiles (K1) and one 1024-px region (K4), each
               rank's output against the unsharded forward (per-marker
               Pearson), f32 at 2 blocks against the CPU's plain chain; the
               forwards' wall and one block's all-reduce timed;
  [tp train 256] the flagship preset's step with its encoder sharded over
               the ranks (K1, K2 and K2's backward terms at those widths):
               the first loss and the LoRA q/v gradients against the
               one-rank step, the replicated tensors identical. [k1
               bf16_tp] and [k2 bf16_tp] hold K1 and K2 at these shapes
               against their plain versions;
  [tp int8 forward] the serving generator in int8 W8A8 (quantize_encoder
               before shard_params: qkv and fc1 cut with their scales, proj
               and fc2 row-split with the rows' amax max-reduced over the
               ranks and the int32 partial products summed), one batch of
               16 tiles and one 1024-px region against the unsharded int8
               forward (per-marker Pearson, the share of uint8 codes equal),
               the all-reduces tallied by dtype; launches a rank: K1 40
               (tiles), K4 40 (region), K3 2, K2 0 (fc1 is an int8 product);
  [tp swin]    unet_lora on ctranspath at full width sharded (stage 0's 3
               heads split 2 + 1, the Swin MLP whole): the f32 forward of
               16 tiles against the unsharded one (per-marker Pearson and
               max error), the bf16 one against the unsharded f32 (the
               bf16-vs-f32 bar: the outputs' spread is a few bf16 steps), then
               two microbatches of the preset's step, the first loss
               against the one-rank step's, the replicated tensors
               identical; no kernel (K1-K8 = 0);
  [tp train 1024] the flagship preset's step on 1024-px regions with its
               encoder sharded: one optimizer step of 2 microbatches, the
               first loss and the LoRA q/v gradients against the one-rank
               step, the replicated tensors identical, and the first
               microbatch in f32 at 2 blocks against one rank's (loss, LoRA
               q/v cosine, reduced norms); launches a rank: K4 = K5 = K2 =
               K2's backward terms = 80 + 2 (12 heads, hidden 2048).
               [k4 bf16_tp_region] and [k5 bf16_tp_region] hold K4 and K5
               at [1, 5334, 12 x 64] against their plain versions.

Before the paths, [head dims] runs the four attention entry points at head
dims 12, 32, 36 and 40 through their kernels (K1, K4, K5, K6; zero-padded
to 64), ln_matmul at N 200 and K 192 and at K 100 (zero-padded to 104)
through K7, and swiglu_fc1 at K 100 and H 100 (padded to 104), with and
without its LayerNorm, through K2, each against its plain version with its
launch counted; [ln_qkv routes] runs ln_qkv_attention where it reaches its
kernels beyond ViT-g's shape (head dim 32, D 96 and D 100 (padded) through
K8, S 4 through K8, S 1280 through K7 -> K4), each against the plain chain
with its launches counted; [rejects] calls each op entry point on the card
at a shape no kernel takes (head dims 80 and 128 for the attention entry
points, K5's and ln_qkv_attention's): each must raise before any launch, as
there is no plain route on the card.

It checks the outputs (the stitched slides against a serial reference
stitch; every served tile against the same tile in a full batch; finite
losses, frozen weights bit-identical and trainable ones moved), the exact
launch counts of every kernel on every path, and the full-width numerics
against the CPU (plain versions there) and between bf16 and f32. Each
phase prints one line with its seconds; any failure ends the run with a
non-zero exit. The line before the card line holds the kernels' summary;
the last line is the device JSON.

Needs one CUDA card and nvcc; there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

BATCH = 64
N_TILES = 150
IMG = 256
REGION = 1024                    # whole-region window side, px
MARKERS = 16
SEED = 0
# every kernel's output (K5's dQ, dK, dV) against its plain version, scaled
# to the reference: max |err| / max |ref| and ||err|| / ||ref|| (at a region
# the gradients are ~0.02 in RMS, so an absolute limit would say little);
# bf16 rounds p (and dS) for the tensor cores, K3's g1, and every output
SCALED_TOL = {"bf16": (2e-2, 1e-2), "f32": (1e-4, 1e-5)}
# K4's lse against the plain version: bf16 inputs, f32 inputs
LSE_TOL = {"bf16": 1e-3, "f32": 1e-5}
F32_CARD_VS_CPU_TOL = 2e-3
MIN_PEARSON = 0.99
SLIDE = 2048                     # synthetic slide side, px
HEADS, HD = 24, 24 * 64          # ViT-g attention
REGION_S = 73 * 73 + 5           # tokens of a 1024-px region window
FC1_K, FC1_H = 1536, 4096        # ViT-g's packed SwiGLU fc1: [2H, K]
HEAD_C = 32                      # the decoder's last fusion width (K3's input)
# the daemon: the CLI's batch, client threads, single-tile requests
SERVE_BATCH, SERVE_CLIENTS, SERVE_REQUESTS = 32, 16, 256
# the H100's published dense peaks and memory rate (NVIDIA data sheet, SXM,
# 700 W), for the least time a kernel's work could take
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
# training: the flagship preset (configs: microbatch 8 x accumulation 2,
# lr_g 2e-4 scaled by sqrt(16), lambda 50, warmup 400)
MICRO, ACCUM, REGION_MICRO = 8, 2, 1
LR_G, LR_D, TOTAL_ITERS, LAMBDA = 2e-4, 2e-4, 1000, 50.0
# f32 train step, card vs CPU at 2 blocks: loss relative; gradients in norm,
# relative (a ReLU input within f32 rounding of 0 may take the other branch
# on the other device and move every gradient upstream of it, ~2e-3 of the
# norm for one element at test sizes)
TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL = 1e-4, 1e-2
# bf16 against f32 train step at full depth: loss relative, and the cosine
# of the LoRA q/v gradients taken together (they flow back through every
# block's attention: K1 at 256 px, K4 and K5 at 1024 px)
BF16_LOSS_RTOL, BF16_LORA_COS = 1e-3, 0.99
# [train ops]: each gradient of the bf16 backward on the card against the
# f32 backward on the CPU, cosine (bf16 rounds the inputs, q/k/v, p and the
# output once each)
OPS_GRAD_COS = 0.999
# the bf16 region step through K5 against the same step through K5's plain
# version: the least cosine of any one LoRA q/v tensor's gradients
K5_STEP_LORA_MIN_COS = 0.999
# the training driver: the flagship preset as ``config.compose(
# ["+default_configs=miphei-vit"])`` resolves it (PyYAML is absent on the
# card; tests/test_torch_config.py holds this dict equal to the port's
# compose), trained on TIFF tiles of 256 px through train_patchgan, 1 epoch
# and a resume to 2, then evaluated by test_model
FLAGSHIP_PRESET = {
    "data": {"slide_dataframe_path": "/root/workdir/data/slide_dataframe.csv",
             "train_dataframe_path": "/root/workdir/data/train_dataframe.csv",
             "val_dataframe_path": "/root/workdir/data/val_dataframe.csv",
             "test_dataframe_path": "/root/workdir/data/test_dataframe.csv",
             "augmentation_dir": None, "channel_stats_path": "channel_stats.json",
             "targ_channel_names": ["Hoechst", "CD31", "CD45", "CD68", "CD4", "FOXP3", "CD8a",
                                    "CD45RO", "CD20", "PD-L1", "CD3e", "CD163", "E-cadherin",
                                    "Ki67", "Pan-CK", "SMA"]},
    "train": {"epochs": 15, "batch_size": 8, "grad_accum_steps": 2, "gan_train": False,
              "gan_mode": "structural", "learning_rate_d": 0.0002, "learning_rate_g": 0.0002,
              "precision": "bf16-mixed", "foreground_head": False, "use_cell_metrics": True,
              "wandb_project": "he-if-image-to-image", "wandb_note": "miphei_vit", "seed": 0,
              "losses": {"lambda_factor": 50, "use_weighted_mae": False,
                         "adversarial_loss": "binary_crossentropy", "perceptual_loss": False,
                         "cell_loss": {"use_loss": False, "use_mse": False,
                                       "use_clustering": False, "mlp_path": "mlp.ckpt"}},
              "callbacks": {"modelcheckpoint": {"mode": "max", "monitor": "val_cell_auc"}},
              "mesh": {"data_axis": "data", "model_axis": None, "num_model_shards": 1,
                       "remat_encoder": True},
              "data_sampler": {"use_sampler": False, "mode": "cell", "tresh": 4,
                               "other_percent": 0.2}},
    "model": {"model_name": "myvitmatte", "dropout": 0.1, "foreground_head": False,
              "checkpoint_path": None,
              "encoder": {"encoder_name": "hoptimus0", "encoder_weights": None},
              "remat_policy": "fc1"},
}
TRAINER_TILES = {"train": 48, "val": 16, "test": 16}
TRAINER_STEPS = 4                # train_patchgan's max_steps_per_epoch
# the single-cell path: disc nuclei a 256-px tile, CellMetrics' capacity, the
# 15 gated markers (Hoechst excluded), the pooled sums against the CPU's
# (relative to the largest), the eval scripts' batch, HEMIT's 512-px tiles
CELL_NUCLEI, POOL_CAPACITY, CELL_MARKERS = 150, 2048, MARKERS - 1
POOL_SUM_RTOL = 1e-5
# the cell loss on the card (f32) against the CPU: value relative, gradient
# norm-relative
CELL_LOSS_RTOL, CELL_GRAD_NORM_RTOL = 1e-4, 1e-3
EVAL_BATCH = 8
HEMIT_IMG, HEMIT_TILES = 512, {"train": 8, "val": 4, "test": 4}
# the baseline generators: the depth of the UNETR's f32 card-vs-CPU check
# (its taps need 4 blocks), the SMP presets' batch (16)
UNETR_CUT, SMP_BATCH = 4, 16
# the foundation-model ablation's ViT encoders besides H-Optimus-0 and
# Prov-GigaPath: univ2 (24 x 1536, SwiGLU, 8 registers), phikonv2 (24 x 1024,
# 16 heads, GELU), sp85m (12 x 768, 12 heads, GELU)
ABLATION_ENCODERS = ("univ2", "phikonv2", "sp85m")
# a ViT encoder's tokens at IMG px, its prefix tokens, heads and whether its
# MLP is SwiGLU (K2) or GELU (no kernel of the port)
ENCODER_GEOMETRY = {"provgigapath": (257, 1, 24, True), "univ2": (333, 9, 24, True),
                    "phikonv2": (257, 1, 16, False), "sp85m": (257, 1, 12, False)}
# [numerics gan]: the spectral u after the step, f32 card against the CPU
GAN_U_TOL = 1e-5
# the baseline generators' f32 card-vs-CPU checks, beside the absolute
# limit: per-marker Pearson, and max |err| of each marker against its map's
# spread max |ref - mean(ref)| (the UNETR's maps sit near a constant, so an
# absolute limit alone would pass features that kept only their mean)
F32_MIN_PEARSON, F32_SPREAD_RTOL = 0.9999, 1e-2
# the UNETR's bf16 forward against f32, each stage's relative error in norm
# (bf16 rounding through 40 blocks, measured 0.3-1.6 % on an H100)
BF16_STAGE_RTOL = 5e-2
# the Swin models: the ctranspath UNETR's forward batch (64, as the other
# UNETRs), the HEMIT generator's (16: its presets train at 4), the zoo's f32
# card-vs-CPU batch, the zoo's netGs (the dual branch is [hemit]'s), the
# train_hemit pairs and the HEMIT-pipeline evaluations' 256-px tiles
CTRANSPATH_BATCH, HEMIT_BATCH, ZOO_BATCH = 64, 16, 2
# the train phases' steady steps, timed with CUDA events after their warm-up steps
TRAIN_TIMED_STEPS = 4
# the GAN step's losses: the generator's total and adversarial terms, the
# discriminator's
GAN_LOSSES = ("gen_loss", "gen_adv_loss", "disc_adv_loss")
ZOO_NETGS = ("resnet_9blocks", "unet_256", "swinT", "swinT_old", "SwinTUnet")
HEMIT_PAIRS = {"train": 8, "val": 4}
HEMIT_EVAL_TILES = {"train": 8, "val": 8, "test": 8}


def preset_with(base: dict, changes: dict, drop=()) -> dict:
    """A copy of the preset ``base`` with dotted ``changes`` set and the
    dotted keys in ``drop`` removed."""
    out = json.loads(json.dumps(base))
    for dotted, value in changes.items():
        *parents, leaf = dotted.split(".")
        node = out
        for part in parents:
            node = node[part]
        node[leaf] = value
    for dotted in drop:
        *parents, leaf = dotted.split(".")
        node = out
        for part in parents:
            node = node[part]
        del node[leaf]
    return out


# the UNETR preset as ``config.compose(["+default_configs=unetr"])`` resolves
# it (tests/test_torch_train_families.py holds it equal)
UNETR_PRESET = preset_with(FLAGSHIP_PRESET, {
    "train.grad_accum_steps": 1, "train.wandb_note": "foundation_model_hoptimus",
    "model.model_name": "unet_lora"}, drop=("model.remat_policy",))


# the Swin presets as ``config.compose`` resolves ``+default_configs=hemit``
# and ``+experiments/foundation_models=ctranspath``
# (tests/test_torch_trainer_families.py holds them equal)
HEMIT_PRESET = preset_with(FLAGSHIP_PRESET, {
    "train.epochs": 20, "train.batch_size": 4, "train.grad_accum_steps": 1,
    "train.wandb_note": "model_hemit", "model.model_name": "hemit",
    "model.encoder.encoder_name": "mobilenet_v2", "model.encoder.encoder_weights": "imagenet",
    "model.encoder_weights": None}, drop=("model.remat_policy",))


def experiment_preset(changes: dict) -> dict:
    """An experiment file's preset: ``+experiments/<group>=<name>`` over the
    base config, which the flagship preset holds but for ``remat_policy``
    and the changes every experiment makes (train: cell, accumulation 1)."""
    return preset_with(FLAGSHIP_PRESET, {"train.grad_accum_steps": 1, **changes},
                       drop=("model.remat_policy",))


CTRANSPATH_PRESET = experiment_preset({
    "train.batch_size": 16, "train.wandb_note": "foundation_model_ctranspath",
    "model.model_name": "unet_lora", "model.encoder.encoder_name": "ctranspath"})


# the paper's ablation presets as ``config.compose(["+experiments/<key>"])``
# resolves them (tests/test_torch_ablation_presets.py holds them equal)
ABLATION_PRESETS = {
    "gan=partial_gan": experiment_preset({
        "train.gan_train": True, "train.wandb_note": "partial_gan",
        "model.model_name": "unet_lora"}),
    "gan=full_gan": experiment_preset({
        "train.gan_train": True, "train.gan_mode": "full", "train.wandb_note": "full_gan",
        "model.model_name": "unet_lora"}),
    "foundation_models=univ2": experiment_preset({
        "train.batch_size": 16, "train.wandb_note": "foundation_model_univ2",
        "model.model_name": "unet_lora", "model.encoder.encoder_name": "univ2"}),
    "finetuning=full_finetuning": experiment_preset({
        "train.wandb_note": "full_uni_finetuning", "model.model_name": "unet",
        "model.encoder.encoder_name": "univ2"}),
    "finetuning=frozen": experiment_preset({
        "train.batch_size": 16, "train.wandb_note": "frozen",
        "model.model_name": "unet_frozen"}),
}


def bound_ms(n_bytes: float, flops: float, dt: str):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for their type."""
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def scaled_err(got, want):
    """(max |err|, max |err| / max |ref|, ||err|| / ||ref||) of one output."""
    got, want = got.float(), want.float()
    err = got - want
    max_abs = err.abs().max().item()
    return max_abs, max_abs / want.abs().max().item(), (err.norm() / want.norm()).item()


def heads_view(t, requires_grad=False):
    """``[B, S, H*64]`` -> a ``[B, H, S, 64]`` view (the library call's layout)."""
    b, s, _ = t.shape
    v = t.detach().view(b, s, -1, 64).transpose(1, 2)
    return v.detach().requires_grad_() if requires_grad else v


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn``'s kernels per call, from a profiler trace of
    ``reps`` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def synth_value(name: str, shape, seed: int) -> np.ndarray:
    """Path-keyed plausible value for one state-dict entry, scaled like
    scripts/make_parity_fixtures.py::synth_value (LoRA B non-zero)."""
    key = int.from_bytes(hashlib.sha256(f"{seed}:{name}".encode()).digest()[:8], "little")
    rng = np.random.Generator(np.random.Philox(key))
    if name.endswith("num_batches_tracked"):
        return np.zeros(shape, np.int64)
    if "running_var" in name:
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if "running_mean" in name:
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.1)
    if name.endswith("gamma"):           # layerscale at trained magnitude
        return (rng.uniform(0.5, 1.5, shape) * 0.1).astype(np.float32)
    if len(shape) == 1 and name.endswith(".weight"):   # LN / BN scale
        return rng.uniform(0.9, 1.1, shape).astype(np.float32)
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)


def write_checkpoint(root: Path, seed: int):
    """A released-style checkpoint dir: ``model.safetensors`` with the
    foundation encoder stripped (LoRA rank 8 adapters + decoder), and the
    H-Optimus-0 encoder as a separate timm-layout file whose position
    embedding is at its 224-px (16x16) grid."""
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.models import get_generator

    shapes = {k: tuple(v.shape) for k, v in get_generator(
        "myvitmatte", IMG, MARKERS, device="meta").state_dict().items()}
    gen, enc = {}, {}
    for name, shape in shapes.items():
        if name.startswith("encoder.vit.") and ".lora_" not in name:
            key = name[len("encoder.vit."):].replace("attn.qkv.qkv.", "attn.qkv.")
            if key == "pos_embed":
                shape = (1, 16 * 16, shape[-1])
            enc[key] = synth_value(key, shape, seed)
        else:
            gen[name] = synth_value(name, shape, seed)
    ckpt = root / "ckpt"
    ckpt.mkdir()
    save_file(gen, ckpt / "model.safetensors")
    save_file(enc, root / "hoptimus0.safetensors")
    n = sum(v.size for v in gen.values()) + sum(v.size for v in enc.values())
    return ckpt, root / "hoptimus0.safetensors", n


def load(ckpt, enc, device, dtype, img=IMG):
    from mipheivit_tpu_torch.infer import cast_params, load_generator, merge_lora

    model = load_generator("myvitmatte", "hoptimus0", ckpt, (img, img), MARKERS,
                           dtype=torch.float32, device=device,
                           encoder_ckpt_path=str(enc), fast_heads=True)
    return cast_params(merge_lora(model), dtype)


def k4_phase(name, q, k, v, seq_len_k=None, heads=HEADS):
    """K4 against its plain version on one input of ``heads`` heads (keys
    past ``seq_len_k`` may hold NaN or Inf: the plain version sees the live
    keys only); prints and checks the errors and times the kernel, the plain
    version and the library's attention on the live keys, with the bound.
    Returns the row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention as attn

    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    live = seq_len_k or k.shape[1]
    kl, vl = k[:, :live], v[:, :live]
    t0 = time.perf_counter()
    with torch.inference_mode():
        out, lse = attn.flash_attention(q, k, v, heads, seq_len_k)
        want_out, want_lse = attn.flash_reference(q, kl, vl, heads)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        out_err, out_rel, out_fro = scaled_err(out, want_out)
        lse_err = (lse - want_lse).abs().max().item()
        del out, lse, want_out, want_lse
        ms = cuda_ms(lambda: attn.flash_attention(q, k, v, heads, seq_len_k), reps=10)
        plain_ms = cuda_ms(lambda: attn.flash_reference(q, kl, vl, heads), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            heads_view(q), heads_view(kl), heads_view(vl)), reps=10)
    b, sq, hd = q.shape
    n_bytes = (2 * b * sq * hd + 2 * b * live * hd) * q.element_size() + b * heads * sq * 4
    bnd, by = bound_ms(n_bytes, 4.0 * b * heads * sq * live * 64, dt)
    print(f"[k4 {name}] q {tuple(q.shape)} k {tuple(k.shape)} seq_len_k {live} out_err "
          f"{out_err:.3e} = {out_rel:.2e} of max|ref|, norm-rel {out_fro:.2e} (tol "
          f"{SCALED_TOL[dt][0]:g}, {SCALED_TOL[dt][1]:g}) lse_err {lse_err:.3e} (tol "
          f"{LSE_TOL[dt]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms library "
          f"(scaled_dot_product_attention) {library_ms:.3f} ms bound {bnd:.3f} ms ({by}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(finite and out_rel <= SCALED_TOL[dt][0] and out_fro <= SCALED_TOL[dt][1]
          and lse_err <= LSE_TOL[dt], f"K4 {name} disagrees with the plain version")
    return {"max_abs_err": out_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": library_ms}


def k5_phase(name, q, k, v, seq_len_k=None, seed=0, heads=HEADS):
    """K5 against its plain version on K4's output for one input of
    ``heads`` heads and a random output gradient; prints and checks the dq/dk/dv errors and times
    the kernel, the plain version, and the library's attention backward
    alone (the row's ``library_ms``) and its forward plus backward, on the
    same (live) keys. Returns the row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention as attn

    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    t0 = time.perf_counter()
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        q.shape, dtype=np.float32)).to(q.device, q.dtype)
    with torch.no_grad():
        out, lse = attn.flash_attention(q, k, v, heads, seq_len_k)
        got = attn.flash_backward(q, k, v, out, lse, g, heads, seq_len_k)
        want = attn.flash_backward_reference(q, k, v, out, lse, g, heads, seq_len_k)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        errs = [scaled_err(a, w) for a, w in zip(got, want)]
        del got, want
        ms = cuda_ms(lambda: attn.flash_backward(q, k, v, out, lse, g, heads, seq_len_k), reps=10)
        plain_ms = cuda_ms(lambda: attn.flash_backward_reference(q, k, v, out, lse, g, heads,
                                                                 seq_len_k), reps=3, warmup=1)
    live = seq_len_k or k.shape[1]
    ql, kl, vl = (heads_view(t, True) for t in (q, k[:, :live], v[:, :live]))
    gl = heads_view(g)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl)
        torch.autograd.grad(o, (ql, kl, vl), gl)

    fwd_bwd_ms = cuda_ms(fwd_bwd, reps=10)
    # the library's backward alone: one forward kept, its gradient timed
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(ql, kl, vl)
        library_ms = cuda_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), gl, retain_graph=True),
                             reps=10)
        del o
    b, sq, hd = q.shape
    n_bytes = 4 * b * (sq + k.shape[1]) * hd * q.element_size() + b * heads * sq * 4
    bnd, by = bound_ms(n_bytes, 10.0 * b * heads * sq * live * 64, dt)
    print(f"[k5 {name}] q {tuple(q.shape)} k {tuple(k.shape)} seq_len_k {live} "
          f"dq/dk/dv err {'/'.join(f'{e[0]:.3e}' for e in errs)} = "
          f"{'/'.join(f'{e[1]:.2e}' for e in errs)} of max|ref|, norm-rel "
          f"{'/'.join(f'{e[2]:.2e}' for e in errs)} (tol {SCALED_TOL[dt][0]:g}, "
          f"{SCALED_TOL[dt][1]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms library backward "
          f"{library_ms:.3f} ms, fwd+bwd {fwd_bwd_ms:.3f} ms bound {bnd:.3f} ms ({by}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(finite and all(e[1] <= SCALED_TOL[dt][0] and e[2] <= SCALED_TOL[dt][1] for e in errs),
          f"K5 {name} disagrees with the plain version")
    return {"max_abs_err": max(e[0] for e in errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": library_ms,
            "library_fwd_bwd_ms": fwd_bwd_ms}


def _count_dicts():
    from mipheivit_tpu_torch.ops import attention, attn_block, mlp, seg_heads

    return (attention.launch_counts, mlp.launch_counts, seg_heads.launch_counts,
            attn_block.launch_counts)


def reset_counts() -> None:
    """Every kernel's launch count to 0 (K1, K4, K5, K6, K2 and its backward
    terms, K7, K3, K8)."""
    for counts in _count_dicts():
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    """The launch counts: attention (K1), flash (K4), flash_bwd (K5), short
    (K6), swiglu (K2), swiglu_bwd (K2's backward terms), ln_matmul (K7),
    seg_heads (K3), attn_block (K8)."""
    return {k: v for counts in _count_dicts() for k, v in counts.items()}


def counts_line(c: dict) -> str:
    return (f"launches K1 {c['attention']} K2 {c['swiglu']} K2-backward {c['swiglu_bwd']} "
            f"K3 {c['seg_heads']} K4 {c['flash']} K5 {c['flash_bwd']} K6 {c['short']} "
            f"K7 {c['ln_matmul']} K8 {c['attn_block']}")


def check_counts(name: str, got: dict, **want) -> None:
    """Exact launch counts of one path: the kernels named in ``want``, the
    rest 0."""
    keys = {"k1": "attention", "k2": "swiglu", "k2b": "swiglu_bwd", "k3": "seg_heads",
            "k4": "flash", "k5": "flash_bwd", "k6": "short", "k7": "ln_matmul",
            "k8": "attn_block"}
    expect = {key: want.get(k, 0) for k, key in keys.items()}
    check(all(got[key] == n for key, n in expect.items()),
          f"{name} {counts_line(got)}, expected {counts_line(expect)}")


def k2_phase(name, m, dtype, ln=False, seed=0, k=FC1_K, h=FC1_H):
    """K2 against its plain version on one input at ViT-g's fc1 widths
    (x [m, 1536], packed w [8192, 1536]; or other K and H; with ``ln`` the
    LayerNorm variant); prints and checks the scaled errors and times the
    kernel, the plain version, the library's packed fc1 GEMM plus gate (and
    its LayerNorm first) and the GEMM alone. Returns the row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import mlp

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.standard_normal((2 * h, k), dtype=np.float32)
                         / np.float32(k ** 0.5)).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal(2 * h, dtype=np.float32)
                         * np.float32(0.1)).to(dev, dtype)
    lnp = None
    if ln:
        lnp = (torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32)).to(dev),
               torch.from_numpy(rng.standard_normal(k, dtype=np.float32)
                                * np.float32(0.1)).to(dev))

    def library():
        xin = x if lnp is None else F.layer_norm(x, (k,), lnp[0].to(dtype), lnp[1].to(dtype),
                                                 1e-6)
        ag = F.linear(xin, w, b)
        return F.silu(ag[:, :h]) * ag[:, h:]

    with torch.inference_mode():
        got = mlp.swiglu_fc1(x, w, b, ln=lnp)
        want = mlp.swiglu_reference(x, w, b, lnp)
        torch.cuda.synchronize()
        err, rel, fro = scaled_err(got, want)
        del got, want
        ms = cuda_ms(lambda: mlp.swiglu_fc1(x, w, b, ln=lnp), reps=10)
        plain_ms = cuda_ms(lambda: mlp.swiglu_reference(x, w, b, lnp), reps=3, warmup=1)
        library_ms = cuda_ms(library, reps=10)
        gemm_ms = cuda_ms(lambda: F.linear(x, w, b), reps=10)
    n_bytes = ((m * k + 2 * h * k + 2 * h + m * h) * x.element_size()
               + (2 * k * 4 if ln else 0))
    bnd, by = bound_ms(n_bytes, 2.0 * m * k * 2 * h, dt)
    print(f"[k2 {name}] x [{m}, {k}] w [{2 * h}, {k}]{' ln' if ln else ''}: max_abs_err "
          f"{err:.3e} = {rel:.2e} of max|ref|, norm-rel {fro:.2e} (tol {SCALED_TOL[dt][0]:g}, "
          f"{SCALED_TOL[dt][1]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms library "
          f"{'LN + ' if ln else ''}GEMM + gate {library_ms:.3f} ms, GEMM alone {gemm_ms:.3f} ms "
          f"bound {bnd:.3f} ms ({by}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(rel <= SCALED_TOL[dt][0] and fro <= SCALED_TOL[dt][1],
          f"K2 {name} disagrees with the plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library_ms, "gemm_ms": gemm_ms}


def k2b_phase(name, m, dtype, seed=0):
    """K2's backward entry point (the elementwise terms da | dg) against its
    plain version on one recomputed ag [m, 8192] and output gradient
    [m, 4096]; prints and checks the scaled errors and times both. There is
    no single library call for these terms. Returns the row's numbers."""
    from mipheivit_tpu_torch.ops import mlp

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    ag = torch.from_numpy(rng.standard_normal((m, 2 * FC1_H), dtype=np.float32)).to(dev, dtype)
    dh = torch.from_numpy(rng.standard_normal((m, FC1_H), dtype=np.float32)
                          * np.float32(1e-3)).to(dev, dtype)
    with torch.no_grad():
        got = mlp.swiglu_gate_grad(ag, dh)
        want = mlp.swiglu_bwd_reference(ag, dh)
        torch.cuda.synchronize()
        err, rel, fro = scaled_err(got, want)
        del got, want
        ms = cuda_ms(lambda: mlp.swiglu_gate_grad(ag, dh), reps=10)
        plain_ms = cuda_ms(lambda: mlp.swiglu_bwd_reference(ag, dh), reps=5, warmup=1)
    n_bytes = 5 * m * FC1_H * ag.element_size()          # ag and dh read, dc written
    bnd, by = bound_ms(n_bytes, 12.0 * m * FC1_H, "f32")
    print(f"[k2 backward {name}] ag [{m}, {2 * FC1_H}] dh [{m}, {FC1_H}]: max_abs_err {err:.3e} = "
          f"{rel:.2e} of max|ref|, norm-rel {fro:.2e} (tol {SCALED_TOL[dt][0]:g}, "
          f"{SCALED_TOL[dt][1]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms library none bound "
          f"{bnd:.3f} ms ({by}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(rel <= SCALED_TOL[dt][0] and fro <= SCALED_TOL[dt][1],
          f"K2's backward {name} disagrees with the plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def head_flops_per_px(k, c=HEAD_C):
    """K3's operations per pixel at k heads of c channels (C2 = c / 2 gate
    features a head): gate c x k c / 2, psi-conv2 k c / 2, taps c x 9k (2
    per multiply-add) and the 9k-term stencil."""
    return 2 * (c * (c // 2) * k + (c // 2) * k + c * 9 * k + 9 * k)


def seeded_heads(seed, device, k=MARKERS, c=HEAD_C):
    """A BatchedSegHeads (c channels, k markers) in eval mode with weights,
    biases and BN statistics from a numpy seed."""
    from mipheivit_tpu_torch.models.mipheivit import BatchedSegHeads

    rng = np.random.default_rng(seed)
    heads = BatchedSegHeads(c, k)
    with torch.no_grad():
        for p in heads.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape), dtype=np.float32)
                                     * np.float32(0.1)))
        heads.psi_bn.running_mean.copy_(torch.from_numpy(
            rng.standard_normal(c // 2 * k, dtype=np.float32) * np.float32(0.1)))
        heads.psi_bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, c // 2 * k).astype(np.float32)))
    return heads.to(device).eval()


def k3_phase(name, b, h, w, dtype, seed=0, k=MARKERS, c=HEAD_C, tag="k3"):
    """K3 against its plain version on one decoder feature map [b, c, h, w]
    (channels_last) with k seeded heads; prints and checks the scaled errors
    and times the kernel, the plain version and the module's plain eval
    chain (cuDNN 1x1 convs, the running-statistics BatchNorm, nine addcmul_;
    the library yardstick). Returns the row's numbers."""
    from mipheivit_tpu_torch.ops import seg_heads

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    heads = seeded_heads(seed, dev, k, c)
    weights = seg_heads.fold_heads(heads, dtype)
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, h, w, c), dtype=np.float32)).to(dev, dtype).permute(0, 3, 1, 2)
    reset_counts()
    with torch.inference_mode():
        got = seg_heads.fused_seg_heads(x, *weights)
        torch.cuda.synchronize()
        check_counts(f"[{tag} {name}]", read_counts(), k3=1)
        want = seg_heads.seg_heads_reference(x, *weights)
        torch.cuda.synchronize()
        err, rel, fro = scaled_err(got, want)
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: seg_heads.fused_seg_heads(x, *weights), reps=10)
        plain_ms = cuda_ms(lambda: seg_heads.seg_heads_reference(x, *weights), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: heads.chain(x), reps=5, warmup=1)
    n_px = b * h * w
    bnd, by = bound_ms(n_px * (c + k) * x.element_size(), 1.0 * n_px * head_flops_per_px(k, c),
                       dt)
    print(f"[{tag} {name}] x [{b}, {c}, {h}, {w}] -> [{b}, {k}, {h}, {w}]: max_abs_err "
          f"{err:.3e} = {rel:.2e} of max|ref|, norm-rel {fro:.2e} (tol {SCALED_TOL[dt][0]:g}, "
          f"{SCALED_TOL[dt][1]:g}), launches K3 1; kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
          f"library (cuDNN eval chain) {library_ms:.3f} ms bound {bnd:.3f} ms ({by}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(rel <= SCALED_TOL[dt][0] and fro <= SCALED_TOL[dt][1],
          f"K3 {name} disagrees with the plain version")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library_ms}


def seeded(shape, seed, dtype, scale=1.0, device="cuda:0"):
    """A standard normal tensor from a numpy seed, times ``scale``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            * np.float32(scale)).to(device, dtype)


def ln_params(d, seed, device="cuda:0"):
    """A LayerNorm's f32 scale (0.5 .. 1.5) and bias from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(device),
            torch.from_numpy(rng.standard_normal(d, dtype=np.float32) * np.float32(0.1)).to(device))


def kernel_row(tag, what, got, want, dt, ms, plain_ms, library_ms, library_what, n_bytes, flops,
               t0):
    """Print one kernel-vs-plain line, check the scaled errors, and return
    the row of the kernels' summary."""
    err, rel, fro = scaled_err(got, want)
    bnd, by = bound_ms(n_bytes, flops, dt)
    print(f"[{tag}] {what}: max_abs_err {err:.3e} = {rel:.2e} of max|ref|, norm-rel {fro:.2e} "
          f"(tol {SCALED_TOL[dt][0]:g}, {SCALED_TOL[dt][1]:g}) kernel {ms:.3f} ms plain "
          f"{plain_ms:.3f} ms library ({library_what}) {library_ms:.3f} ms bound {bnd:.3f} ms "
          f"({by}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= SCALED_TOL[dt][0]
          and fro <= SCALED_TOL[dt][1], f"{tag} disagrees with the plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library_ms}


def k1_fused_phase(name, b, s, heads, seed):
    """K1 off a fused qkv ``[b, s, 3 x heads x 64]`` in bf16 (a qkv
    projection's output) against its plain version, with SDPA's time and
    the bound: [tp forward]'s shape (one rank's HEADS / PAR_RANKS heads of
    TP_TILES tiles) and the ablation encoders' at batch 64. Returns the
    row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention as attn

    t0 = time.perf_counter()
    hd = heads * 64
    qkv = seeded((b, s, 3 * hd), seed, torch.bfloat16)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]

    def view(t):
        return t.view(b, s, heads, 64).transpose(1, 2)

    with torch.inference_mode():
        got = attn.attention_qkv(qkv, heads)
        want = attn.attention_reference(q, k, v, heads)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: attn.attention_qkv(qkv, heads))
        plain_ms = cuda_ms(lambda: attn.attention_reference(q, k, v, heads), reps=5, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(view(q), view(k), view(v)))
    return kernel_row(f"k1 {name}", f"fused qkv {tuple(qkv.shape)} at {heads} heads", got, want,
                      "bf16", ms, plain_ms, library_ms, "scaled_dot_product_attention",
                      4 * b * s * hd * qkv.element_size(), 4.0 * b * heads * s * s * 64, t0)


def k6_phase(name, b, s, dtype, seed=0):
    """K6 (dot_product_attention up to 512 tokens) against its plain version
    on q, k, v [b, 24, s, 64], with the library's attention on the same
    tensors timed beside it. Returns the row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention as attn

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    t0 = time.perf_counter()
    q, k, v = (seeded((b, HEADS, s, 64), seed + i, dtype) for i in range(3))
    with torch.inference_mode():
        got = attn.dot_product_attention(q, k, v)
        want = attn.short_attention_reference(q, k, v)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: attn.dot_product_attention(q, k, v), reps=10)
        plain_ms = cuda_ms(lambda: attn.short_attention_reference(q, k, v), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=10)
    return kernel_row(f"k6 {name}", f"q, k, v [{b}, {HEADS}, {s}, 64]", got, want, dt, ms,
                      plain_ms, library_ms, "scaled_dot_product_attention",
                      4 * b * HEADS * s * 64 * q.element_size(), 4.0 * b * HEADS * s * s * 64, t0)


def k6_long_check():
    """dot_product_attention above 512 tokens reaches K4 and not K6."""
    from mipheivit_tpu_torch.ops import attention as attn

    q, k, v = (seeded((2, HEADS, 640, 64), SEED + 80 + i, torch.bfloat16) for i in range(3))
    reset_counts()
    with torch.inference_mode():
        got = attn.dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        counts = read_counts()
        rows = [t.transpose(1, 2).reshape(2, 640, HD) for t in (q, k, v)]
        want = attn.flash_reference(*rows, HEADS)[0].view(2, 640, HEADS, 64).transpose(1, 2)
    _, rel, fro = scaled_err(got, want)
    print(f"[k6 long] q, k, v [2, {HEADS}, 640, 64] bf16: {counts_line(counts)}; against K4's "
          f"plain version {rel:.2e} of max|ref|, norm-rel {fro:.2e}", flush=True)
    check_counts("[k6 long]", counts, k4=1)
    check(rel <= SCALED_TOL["bf16"][0] and fro <= SCALED_TOL["bf16"][1],
          "dot_product_attention above 512 tokens disagrees with K4's plain version")


def k7_phase(name, m, dtype, seed=0):
    """K7 (ln_matmul) against its plain version at ViT-g's qkv projection
    (x [m, 1536], w [4608, 1536]), with the library's LayerNorm + linear
    timed beside it. Returns the row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import mlp

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    t0 = time.perf_counter()
    x = seeded((m, HD), seed, dtype)
    lns, lnb = ln_params(HD, seed + 1)
    w = seeded((3 * HD, HD), seed + 2, dtype, HD ** -0.5)
    b = seeded(3 * HD, seed + 3, dtype, 0.1)
    lns_t, lnb_t = lns.to(dtype), lnb.to(dtype)
    with torch.inference_mode():
        got = mlp.ln_matmul(x, lns, lnb, w, b)
        want = mlp.ln_matmul_reference(x, lns, lnb, w, b)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: mlp.ln_matmul(x, lns, lnb, w, b), reps=10)
        plain_ms = cuda_ms(lambda: mlp.ln_matmul_reference(x, lns, lnb, w, b), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: F.linear(F.layer_norm(x, (HD,), lns_t, lnb_t, 1e-6), w, b),
                             reps=10)
    n_bytes = (m * HD + 3 * HD * HD + 3 * HD + m * 3 * HD) * x.element_size() + 2 * HD * 4
    return kernel_row(f"k7 {name}", f"x [{m}, {HD}] w [{3 * HD}, {HD}]", got, want, dt, ms,
                      plain_ms, library_ms, "layer_norm + linear", n_bytes,
                      2.0 * m * HD * 3 * HD, t0)


def k8_phase(name, b, s, dtype, seed=0):
    """K8 (ln_qkv_attention) against the plain chain at ViT-g's attention
    sublayer (x [b, s, 1536], 24 heads of 64, w [4608, 1536]), with the
    library's LayerNorm + linear + attention timed beside it. Returns the
    row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attn_block

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    t0 = time.perf_counter()
    x = seeded((b, s, HD), seed, dtype)
    lns, lnb = ln_params(HD, seed + 1)
    w = seeded((3 * HD, HD), seed + 2, dtype, HD ** -0.5)
    bias = seeded(3 * HD, seed + 3, dtype, 0.1)
    lns_t, lnb_t = lns.to(dtype), lnb.to(dtype)

    def library():
        qkv = F.linear(F.layer_norm(x, (HD,), lns_t, lnb_t, 1e-6), w, bias)
        q, k, v = (t.view(b, s, HEADS, 64).transpose(1, 2) for t in qkv.split(HD, -1))
        return F.scaled_dot_product_attention(q, k, v)

    with torch.inference_mode():
        got = attn_block.ln_qkv_attention(x, lns, lnb, w, bias, HEADS)
        want = attn_block.chain_reference(x, lns, lnb, w, bias, HEADS)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: attn_block.ln_qkv_attention(x, lns, lnb, w, bias, HEADS), reps=10)
        plain_ms = cuda_ms(lambda: attn_block.chain_reference(x, lns, lnb, w, bias, HEADS),
                           reps=3, warmup=1)
        library_ms = cuda_ms(library, reps=10)
    n_bytes = (b * s * HD + 3 * HD * HD + 3 * HD + b * s * HD) * x.element_size() + 2 * HD * 4
    flops = 2.0 * b * s * HD * 3 * HD + 4.0 * b * HEADS * s * s * 64
    return kernel_row(f"k8 {name}", f"x [{b}, {s}, {HD}], {HEADS} heads", got, want, dt, ms,
                      plain_ms, library_ms, "layer_norm + linear + scaled_dot_product_attention",
                      n_bytes, flops, t0)


def head_dims_phase():
    """The attention entry points at head dims 12, 32, 36 and 40 through the
    kernels (zero-padded to 64, the scale of their own D): attention_qkv at
    S 329 (K1), attention_bshd at S 600 (K4), flash_backward there (K5),
    dot_product_attention at S 329 (K6), each at 24 heads in bf16, held
    against its plain version at that D with its launch counted; ln_matmul
    at N 200 and K 192 (K7) and at K 100 (zero-padded to 104), and
    swiglu_fc1 at K 100 and H 100 (padded to 104), with and without its
    LayerNorm (K2), each with exactly one launch."""
    from mipheivit_tpu_torch.ops import attention as attn
    from mipheivit_tpu_torch.ops import mlp

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    lines = []
    for d in (12, 32, 36, 40):
        qkv = seeded((4, 329, 3 * HEADS * d), SEED + 140 + d, bf16)
        lq, lk, lv = seeded((1, 600, 3 * HEADS * d), SEED + 141 + d, bf16).chunk(3, -1)
        g = seeded((1, 600, HEADS * d), SEED + 142 + d, bf16)
        lout, llse = attn.flash_reference(lq, lk, lv, HEADS)
        heads = [seeded((4, HEADS, 329, d), SEED + 143 + d + i, bf16) for i in range(3)]
        cases = {
            "attention_qkv": ("attention", lambda: attn.attention_qkv(qkv, HEADS),
                              lambda: attn.attention_reference(*qkv.chunk(3, -1), HEADS)),
            "attention_bshd": ("flash", lambda: attn.attention_bshd(lq, lk, lv, HEADS),
                               lambda: attn.flash_reference(lq, lk, lv, HEADS)[0]),
            "flash_backward": ("flash_bwd",
                               lambda: torch.cat(attn.flash_backward(
                                   lq, lk, lv, lout, llse, g, HEADS), -1),
                               lambda: torch.cat(attn.flash_backward_reference(
                                   lq, lk, lv, lout, llse, g, HEADS), -1)),
            "dot_product_attention": ("short", lambda: attn.dot_product_attention(*heads),
                                      lambda: attn.short_attention_reference(*heads)),
        }
        for name, (key, op, plain) in cases.items():
            reset_counts()
            with torch.inference_mode():
                got = op()
                torch.cuda.synchronize()
                counts = read_counts()
                want = plain()
            _, rel, fro = scaled_err(got, want)
            ok = (counts[key] == 1 and sum(counts.values()) == 1 and bool(torch.isfinite(got).all())
                  and rel <= SCALED_TOL["bf16"][0] and fro <= SCALED_TOL["bf16"][1])
            lines.append(f"{name} D {d}: {rel:.2e} of max|ref|, norm-rel {fro:.2e}, "
                         f"launches {counts[key]}")
            check(ok, f"[head dims] {name} at D {d}: {counts_line(counts)}, {rel:.2e}, {fro:.2e}")
    # K7 and K2 off their kernels' widths: (name, count key, op, plain)
    mats = []
    for k, n in ((192, 200), (100, 256)):
        x = seeded((658, k), SEED + 150 + k, bf16)
        lns, lnb = ln_params(k, SEED + 151 + k)
        w, b = seeded((n, k), SEED + 152 + k, bf16, k ** -0.5), seeded(n, SEED + 153 + k, bf16, 0.1)
        mats.append((f"ln_matmul [658, {k}] x [{n}, {k}]", "ln_matmul",
                     lambda x=x, a=(lns, lnb, w, b): mlp.ln_matmul(x, *a),
                     lambda x=x, a=(lns, lnb, w, b): mlp.ln_matmul_reference(x, *a)))
    x = seeded((658, 100), SEED + 154, bf16)
    w, b = seeded((200, 100), SEED + 155, bf16, 0.1), seeded(200, SEED + 156, bf16, 0.1)
    for lnp in (None, ln_params(100, SEED + 157)):
        mats.append((f"swiglu_fc1 [658, 100] x [200, 100]{' ln' if lnp else ''}", "swiglu",
                     lambda lnp=lnp: mlp.swiglu_fc1(x, w, b, ln=lnp),
                     lambda lnp=lnp: mlp.swiglu_reference(x, w, b, lnp)))
    for name, key, op, plain in mats:
        reset_counts()
        with torch.inference_mode():
            got = op()
            torch.cuda.synchronize()
            counts = read_counts()
            want = plain()
        _, rel, fro = scaled_err(got, want)
        lines.append(f"{name}: {rel:.2e} of max|ref|, norm-rel {fro:.2e}, launches {counts[key]}")
        check(counts[key] == 1 and sum(counts.values()) == 1 and got.shape == want.shape
              and bool(torch.isfinite(got).all()) and rel <= SCALED_TOL["bf16"][0]
              and fro <= SCALED_TOL["bf16"][1],
              f"[head dims] {name}: {counts_line(counts)}, {rel:.2e}, {fro:.2e}")
    reset_counts()
    print(f"[head dims] {'; '.join(lines)} (tol {SCALED_TOL['bf16'][0]:g}, "
          f"{SCALED_TOL['bf16'][1]:g}) ({time.perf_counter() - t0:.1f} s)", flush=True)


WIDE_HEAD_DIMS = (80, 128)        # [head dims 128]: through K4's and K5's 128-wide instances
WIDE_REGION = (1, REGION_S, 12)   # a 1024-px region at 12 heads of 128 (ViT width 1536)


def wide_rows(d, q, k, v, g, heads):
    """Times of K4's and K5's instance for head dim d on q, k, v [B, S, H*d]
    (bf16) and the output gradient g: the kernel, its plain version, the
    library's attention (its backward alone for K5) on the same heads, and
    the bound. Returns ``{"k4": row, "k5": row}``."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention as attn

    b, s, hd = q.shape

    def view(t, grad=False):
        t = t.detach().view(b, s, heads, d).transpose(1, 2)
        return t.detach().requires_grad_() if grad else t

    rows = {}
    with torch.inference_mode():
        out, lse = attn.flash_attention(q, k, v, heads)
        rows["k4"] = {"ms": cuda_ms(lambda: attn.flash_attention(q, k, v, heads), reps=10),
                      "plain_ms": cuda_ms(lambda: attn.flash_reference(q, k, v, heads), reps=2,
                                          warmup=1),
                      "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                          view(q), view(k), view(v)), reps=10)}
        rows["k5"] = {"ms": cuda_ms(lambda: attn.flash_backward(q, k, v, out, lse, g, heads),
                                    reps=10),
                      "plain_ms": cuda_ms(lambda: attn.flash_backward_reference(
                          q, k, v, out, lse, g, heads), reps=2, warmup=1)}
    ql, kl, vl = (view(t, True) for t in (q, k, v))
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(ql, kl, vl)
        rows["k5"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o, (ql, kl, vl), view(g), retain_graph=True), reps=10)
        del o
    n = b * s * hd * q.element_size()
    rows["k4"]["bound_ms"], rows["k4"]["bound_by"] = bound_ms(
        4 * n + b * heads * s * 4, 4.0 * b * heads * s * s * d, "bf16")
    rows["k5"]["bound_ms"], rows["k5"]["bound_by"] = bound_ms(
        8 * n + b * heads * s * 4, 10.0 * b * heads * s * s * d, "bf16")
    return rows


def wide_heads_phase():
    """[head dims 128]: the five attention entry points and flash_backward
    at head dims 80 and 128, through K4's and K5's 128-wide instances (80
    zero-padded to 128, the scale of its own D): attention_qkv at [2, 329,
    24 x D] and dot_product_attention at [2, 24, 329, D] (up to 512 tokens,
    K4 where K1 and K6 take heads up to 64), attention_bshd at [1, 600, 24 x
    D], flash_attention over its keys from 300 queries with 580 live keys,
    flash_backward there (K5), ln_qkv_attention at [2, 329, 1536] with 2
    heads of 80 or 12 of 128 (K7, then K4), and attention_bshd and
    flash_backward in f32; each held against its plain version at that D
    with its exact launches. Then K4's and K5's 128-wide times at [1, 600,
    24 x 128] and at a 1024-px region of 12 heads of 128, beside the
    library's attention and the bound. Returns the K4 and K5 rows at the
    region."""
    from mipheivit_tpu_torch.ops import attention as attn
    from mipheivit_tpu_torch.ops import attn_block

    t0 = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    lines = []
    for d in WIDE_HEAD_DIMS:
        seed = SEED + 170 + d
        qkv = seeded((2, 329, 3 * HEADS * d), seed, bf16)
        lq, lk, lv = seeded((1, 600, 3 * HEADS * d), seed + 1, bf16).chunk(3, -1)
        g = seeded((1, 600, HEADS * d), seed + 2, bf16)
        lout, llse = attn.flash_reference(lq, lk, lv, HEADS)
        heads = [seeded((2, HEADS, 329, d), seed + 3 + i, bf16) for i in range(3)]
        fq, fk, fv = seeded((1, 600, 3 * 2 * d), seed + 6, f32).chunk(3, -1)
        fg = seeded((1, 600, 2 * d), seed + 7, f32)
        fout, flse = attn.flash_reference(fq, fk, fv, 2)
        nh = 1536 // d if 1536 % d == 0 else 2
        x = seeded((2, 329, HD), seed + 8, bf16)
        lns, lnb = ln_params(HD, seed + 9)
        w, bias = seeded((3 * nh * d, HD), seed + 10, bf16, HD ** -0.5), seeded(
            3 * nh * d, seed + 11, bf16, 0.1)
        cases = {
            f"attention_qkv [2, 329, 24x{d}]": (
                {"k4": 1}, lambda: attn.attention_qkv(qkv, HEADS),
                lambda: attn.flash_reference(*qkv.chunk(3, -1), HEADS)[0]),
            f"attention_bshd [1, 600, 24x{d}]": (
                {"k4": 1}, lambda: attn.attention_bshd(lq, lk, lv, HEADS),
                lambda: attn.flash_reference(lq, lk, lv, HEADS)[0]),
            f"flash_attention [1, 300] over [1, 600] (580 live), 24x{d}": (
                {"k4": 1}, lambda: attn.flash_attention(lq[:, :300], lk, lv, HEADS, 580)[0],
                lambda: attn.flash_reference(lq[:, :300], lk[:, :580], lv[:, :580], HEADS)[0]),
            f"flash_backward [1, 600, 24x{d}]": (
                {"k5": 1}, lambda: torch.cat(attn.flash_backward(
                    lq, lk, lv, lout, llse, g, HEADS), -1),
                lambda: torch.cat(attn.flash_backward_reference(
                    lq, lk, lv, lout, llse, g, HEADS), -1)),
            f"dot_product_attention [2, 24, 329, {d}]": (
                {"k4": 1}, lambda: attn.dot_product_attention(*heads),
                lambda: attn.short_attention_reference(*heads)),
            f"ln_qkv_attention [2, 329, 1536], {nh} heads of {d}": (
                {"k7": 1, "k4": 1}, lambda: attn_block.ln_qkv_attention(x, lns, lnb, w, bias, nh),
                lambda: attn_block.chain_reference(x, lns, lnb, w, bias, nh)),
            f"attention_bshd f32 [1, 600, 2x{d}]": (
                {"k4": 1}, lambda: attn.attention_bshd(fq, fk, fv, 2),
                lambda: attn.flash_reference(fq, fk, fv, 2)[0]),
            f"flash_backward f32 [1, 600, 2x{d}]": (
                {"k5": 1}, lambda: torch.cat(attn.flash_backward(fq, fk, fv, fout, flse, fg, 2), -1),
                lambda: torch.cat(attn.flash_backward_reference(
                    fq, fk, fv, fout, flse, fg, 2), -1)),
        }
        for name, (want, op, plain) in cases.items():
            reset_counts()
            with torch.inference_mode():
                got = op()
                torch.cuda.synchronize()
                counts = read_counts()
                ref = plain()
            dt = "f32" if got.dtype == f32 else "bf16"
            _, rel, fro = scaled_err(got, ref)
            lines.append(f"{name}: {rel:.2e} of max|ref|, norm-rel {fro:.2e} (tol "
                         f"{SCALED_TOL[dt][0]:g}, {SCALED_TOL[dt][1]:g}), {counts_line(counts)}")
            check(got.shape == ref.shape and bool(torch.isfinite(got).all())
                  and rel <= SCALED_TOL[dt][0] and fro <= SCALED_TOL[dt][1],
                  f"[head dims 128] {name} disagrees with its plain version: {rel:.2e}, {fro:.2e}")
            check_counts(f"[head dims 128] {name}", counts, **want)
        del qkv, lq, lk, lv, g, lout, llse, heads, x, w
    reset_counts()
    print(f"[head dims 128] {'; '.join(lines)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.empty_cache()
    rows = {}
    for tag, (b, s_, nh) in (("[1, 600, 24x128]", (1, 600, HEADS)), ("region", WIDE_REGION)):
        t0 = time.perf_counter()
        q, k, v = seeded((b, s_, 3 * nh * 128), SEED + 190 + s_, bf16).chunk(3, -1)
        g = seeded((b, s_, nh * 128), SEED + 191 + s_, bf16)
        rows = wide_rows(128, q, k, v, g, nh)
        for kern, r in rows.items():
            print(f"[head dims 128 {kern}] D 128 at {tag} [{b}, {s_}, {nh}x128] kernel "
                  f"{r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms library "
                  f"(scaled_dot_product_attention{' backward' if kern == 'k5' else ''}) "
                  f"{r['library_ms']:.3f} ms bound {r['bound_ms']:.3f} ms ({r['bound_by']}) "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del q, k, v, g
    torch.cuda.empty_cache()
    return rows


def k3_widths_phase():
    """[k3 widths]: K3 at decoder widths other than 32 channels (C2 = C /
    2), against its plain version with one launch each and its times:
    C 16 and 64 on 64 tiles of 256 px, C 48 (zero-padded to 64 channels and
    32 features) and C 64 at 19 markers (two passes, pixel stores) on 8
    tiles, and C 64 in f32. Returns the rows of C 16 and 64."""
    bf16 = torch.bfloat16
    rows = {c: k3_phase(f"bf16_c{c}", BATCH, IMG, IMG, bf16, seed=SEED + 200 + c, c=c,
                        tag="k3 widths") for c in (16, 64)}
    k3_phase("bf16_c48", 8, IMG, IMG, bf16, seed=SEED + 248, c=48, tag="k3 widths")
    k3_phase("bf16_c64_panel19", 8, IMG, IMG, bf16, seed=SEED + 264, k=19, c=64,
             tag="k3 widths")
    k3_phase("f32_c64", 2, IMG, IMG, torch.float32, seed=SEED + 265, c=64, tag="k3 widths")
    torch.cuda.empty_cache()
    return rows


def ln_qkv_routes_phase():
    """ln_qkv_attention on the card beyond ViT-g's shape, each route held
    against the plain chain under the bf16 rule with its exact launch
    counts: 24 heads of 32 at D 1536 and S 329 (K8, the heads padded to 64),
    2 heads of 64 at D 96 (K8), 2 heads of 32 at D 100 (K8, D zero-padded to
    104), S 4 at 64 tiles (K8), and S 1280 (above K8's 1024 tokens: K7, then
    K4 through attention_qkv)."""
    from mipheivit_tpu_torch.ops import attn_block

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    # name: (b, s, d, heads, head dim, launches)
    cases = {"head dim 32": (4, 329, HD, HEADS, 32, {"k8": 1}),
             "D 96, 2 heads of 64": (4, 329, 96, 2, 64, {"k8": 1}),
             "D 100, 2 heads of 32": (4, 329, 100, 2, 32, {"k8": 1}),
             "S 4": (BATCH, 4, HD, HEADS, 64, {"k8": 1}),
             "S 1280": (1, 1280, HD, HEADS, 64, {"k7": 1, "k4": 1})}
    lines = []
    for i, (name, (b, s_, d, heads, dh, want)) in enumerate(cases.items()):
        seed = SEED + 160 + 10 * i
        x = seeded((b, s_, d), seed, bf16)
        lns, lnb = ln_params(d, seed + 1)
        w = seeded((3 * heads * dh, d), seed + 2, bf16, d ** -0.5)
        bias = seeded(3 * heads * dh, seed + 3, bf16, 0.1)
        reset_counts()
        with torch.inference_mode():
            got = attn_block.ln_qkv_attention(x, lns, lnb, w, bias, heads)
            torch.cuda.synchronize()
            counts = read_counts()
            ref = attn_block.chain_reference(x, lns, lnb, w, bias, heads)
        _, rel, fro = scaled_err(got, ref)
        lines.append(f"{name} x [{b}, {s_}, {d}] ({attn_block.route(b, s_, d, heads, dh)}): "
                     f"{rel:.2e} of max|ref|, norm-rel {fro:.2e}, {counts_line(counts)}")
        check(got.shape == (b, s_, heads * dh) and bool(torch.isfinite(got).all())
              and rel <= SCALED_TOL["bf16"][0] and fro <= SCALED_TOL["bf16"][1],
              f"[ln_qkv routes] {name} disagrees with the plain chain: {rel:.2e}, {fro:.2e}")
        check_counts(f"[ln_qkv routes] {name}", counts, **want)
    reset_counts()
    print(f"[ln_qkv routes] {'; '.join(lines)} (tol {SCALED_TOL['bf16'][0]:g}, "
          f"{SCALED_TOL['bf16'][1]:g}) ({time.perf_counter() - t0:.1f} s)", flush=True)


def rejects_phase():
    """Each op entry point on the card at a shape no kernel takes: the
    attention entry points at head dim 136, above the 128 of K4's and K5's
    wide instance (attention_qkv at 24 heads and S 329; attention_bshd at S
    600; flash_backward there, K5's; dot_product_attention), ln_qkv_attention
    at 2 heads of 136, and K3 at a decoder width of 80 channels, above its
    64. Each must raise ValueError with no kernel launch: on the card an
    entry point launches its kernels or raises. (Head dims up to 128 reach
    the kernels zero-padded to 64 or 128 ([head dims], [head dims 128]);
    widths that are not multiples of 8, as ln_matmul at K 100 and
    ln_qkv_attention at D 100, reach K7, K2 and K8 zero-padded ([head dims],
    [ln_qkv routes]); K3 takes 16 to 64 channels zero-padded ([k3 widths]),
    as the JAX entry points serve them.)"""
    from mipheivit_tpu_torch.ops import attention as attn
    from mipheivit_tpu_torch.ops import attn_block, seg_heads

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    d = 136
    qkv = seeded((2, 329, 3 * HEADS * d), SEED + 120, bf16)
    long_q, long_k, long_v = seeded((1, 600, 3 * HEADS * d), SEED + 121, bf16).chunk(3, -1)
    g = seeded((1, 600, HEADS * d), SEED + 122, bf16)
    out, lse = attn.flash_reference(long_q, long_k, long_v, HEADS)
    heads = [seeded((2, HEADS, 329, d), SEED + 123 + i, bf16) for i in range(3)]
    x = seeded((2, 329, HD), SEED + 130, bf16)
    lns, lnb = ln_params(HD, SEED + 131)
    w, b = seeded((3 * 2 * d, HD), SEED + 132, bf16, HD ** -0.5), seeded(6 * d, SEED + 133, bf16)
    k3_heads = seeded_heads(SEED + 134, torch.device("cuda:0"), MARKERS, 80)
    k3_x = seeded((2, 64, 64, 80), SEED + 135, bf16).permute(0, 3, 1, 2)
    cases = {
        f"attention_qkv [2, 329, 24x{d}]": lambda: attn.attention_qkv(qkv, HEADS),
        f"attention_bshd [1, 600, 24x{d}]": lambda: attn.attention_bshd(long_q, long_k, long_v,
                                                                        HEADS),
        f"flash_backward [1, 600, 24x{d}]": lambda: attn.flash_backward(
            long_q, long_k, long_v, out, lse, g, HEADS),
        f"dot_product_attention [2, 24, 329, {d}]": lambda: attn.dot_product_attention(*heads),
        f"ln_qkv_attention [2, 329, 1536], 2 heads of {d}": lambda: attn_block.ln_qkv_attention(
            x, lns, lnb, w, b, 2),
        "fused_seg_heads [2, 80, 64, 64]": lambda: seg_heads.fused_seg_heads(
            k3_x, *seg_heads.fold_heads(k3_heads, bf16)),
    }
    lines, ok = [], True
    for name, op in cases.items():
        reset_counts()
        try:
            with torch.inference_mode():
                op()
            torch.cuda.synchronize()
            raised = "returned"
        except ValueError as e:
            raised = f"raised ({e})"
        launched = {k: n for k, n in read_counts().items() if n}
        ok = ok and raised != "returned" and not launched
        lines.append(f"{name}: {raised}, launches {launched or 0}")
    reset_counts()
    print(f"[rejects] {'; '.join(lines)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(ok, "[rejects] an op entry point did not raise, before any launch, on a shape its "
              "kernel does not take")


def block0_tokens(model, x):
    """The encoder's tokens of the images ``x`` as its first block receives
    them (the encoder run with its blocks cut to the first)."""
    vit = model.encoder.vit
    got = []
    hook = vit.blocks[0].register_forward_pre_hook(lambda _m, args: got.append(args[0]))
    blocks, vit.blocks = vit.blocks, vit.blocks[:1]
    try:
        with torch.inference_mode():
            vit(x)
    finally:
        vit.blocks = blocks
        hook.remove()
    return got[0]


def attn_sublayer_phase(model, x):
    """Block 0's attention sublayer before ``proj`` on the tokens of the
    images ``x``, three ways: the model's own route (norm1 -> qkv ->
    attention_qkv: K1), ln_matmul -> attention_qkv (K7 + K1) and
    ln_qkv_attention (K8), with the launch counts at 0; each held against
    the f32 plain chain on the same weights, and timed. Returns the counts."""
    from mipheivit_tpu_torch.ops import attn_block
    from mipheivit_tpu_torch.ops.attention import attention_qkv
    from mipheivit_tpu_torch.ops.mlp import ln_matmul

    t0 = time.perf_counter()
    blk = model.encoder.vit.blocks[0]
    n1, qkv = blk.norm1, blk.attn.qkv
    tokens = block0_tokens(model, x)
    routes = {
        "model (norm1 -> qkv -> attention_qkv)": lambda: attention_qkv(qkv(n1(tokens)), HEADS),
        "ln_matmul -> attention_qkv": lambda: attention_qkv(
            ln_matmul(tokens, n1.weight, n1.bias, qkv.weight, qkv.bias, n1.eps), HEADS),
        "ln_qkv_attention": lambda: attn_block.ln_qkv_attention(
            tokens, n1.weight, n1.bias, qkv.weight, qkv.bias, HEADS, n1.eps),
    }
    reset_counts()
    with torch.inference_mode():
        outs = {name: fn() for name, fn in routes.items()}
        torch.cuda.synchronize()
        counts = read_counts()
        want = attn_block.chain_reference(tokens.float(), n1.weight.float(), n1.bias.float(),
                                          qkv.weight.float(), qkv.bias.float(), HEADS, n1.eps)
        errs = {name: scaled_err(out, want) for name, out in outs.items()}
        times = {name: cuda_ms(fn, reps=10) for name, fn in routes.items()}
    print(f"[attn sublayer] block 0 of the loaded generator, tokens {tuple(tokens.shape)} "
          f"{tokens.dtype}, against the f32 plain chain: "
          + "; ".join(f"{name} {e[1]:.2e} of max|ref|, norm-rel {e[2]:.2e}, {times[name]:.3f} ms"
                      for name, e in errs.items())
          + f" (tol {SCALED_TOL['bf16'][0]:g}, {SCALED_TOL['bf16'][1]:g}); {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(all(bool(torch.isfinite(o).all()) for o in outs.values()), "[attn sublayer] non-finite")
    check(all(e[1] <= SCALED_TOL["bf16"][0] and e[2] <= SCALED_TOL["bf16"][1]
              for e in errs.values()), "[attn sublayer] a route disagrees with the plain chain")
    check_counts("[attn sublayer]", counts, k1=2, k7=1, k8=1)
    return counts


def train_ops_phase(dev):
    """One bf16 forward and backward on the card through each of
    dot_product_attention (q, k, v [64, 24, 329, 64]), ln_matmul (x [21056,
    1536], w [4608, 1536]) and ln_qkv_attention (x [64, 329, 1536]) with
    every input needing grad, and the same at a two-item slice held in
    cosine against the f32 backward on the CPU, with the launch counts at
    0. Returns the counts."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention, attn_block, mlp

    t0 = time.perf_counter()
    lns, lnb = ln_params(HD, SEED + 90)
    w = seeded((3 * HD, HD), SEED + 91, torch.bfloat16, HD ** -0.5)
    b = seeded(3 * HD, SEED + 92, torch.bfloat16, 0.1)
    x_rows = seeded((BATCH * 329, HD), SEED + 96, torch.bfloat16)
    # name: (function, inputs, output shape, leading inputs cut to the slice,
    # rows of the slice)
    cases = {
        "dot_product_attention": (attention.dot_product_attention,
                                  [seeded((BATCH, HEADS, 329, 64), SEED + 93 + i, torch.bfloat16)
                                   for i in range(3)], (BATCH, HEADS, 329, 64), 3, 2),
        "ln_matmul": (mlp.ln_matmul, [x_rows, lns, lnb, w, b], (BATCH * 329, 3 * HD), 1,
                      2 * 329),
        "ln_qkv_attention": (lambda *a: attn_block.ln_qkv_attention(*a, HEADS),
                             [x_rows.view(BATCH, 329, HD), lns, lnb, w, b], (BATCH, 329, HD), 1, 2),
    }

    def grads(fn, inputs, r):
        ts = [t.detach().clone().requires_grad_() for t in inputs]
        (fn(*ts).float() * r).sum().backward()
        return [t.grad for t in ts]

    reset_counts()
    lines, ok = [], True
    for name, (fn, inputs, shape, n_cut, rows) in cases.items():
        t1 = time.perf_counter()
        r = seeded(shape, SEED + 98, torch.float32)
        full = grads(fn, inputs, r)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(g).all()) for g in full)
        del full
        small = [t[:rows] for t in inputs[:n_cut]] + inputs[n_cut:]
        card = grads(fn, small, r[:rows])
        cpu = grads(fn, [t.detach().float().cpu() for t in small], r[:rows].cpu())
        cos = [float(F.cosine_similarity(a.float().cpu().flatten(), c.flatten(), 0))
               for a, c in zip(card, cpu)]
        ok = ok and finite and min(cos) >= OPS_GRAD_COS
        lines.append(f"{name}: {tuple(inputs[0].shape)} bf16 backward finite {finite}, "
                     f"{tuple(small[0].shape)} card bf16 vs CPU f32 gradient cosine "
                     f"{', '.join(f'{c:.6f}' for c in cos)} ({time.perf_counter() - t1:.1f} s)")
        del card, cpu
        torch.cuda.empty_cache()
    counts = read_counts()
    print(f"[train ops] {'; '.join(lines)} (target >= {OPS_GRAD_COS}); {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(ok, "[train ops] a bf16 backward is not finite or does not track the f32 one")
    check_counts("[train ops]", counts, k6=2, k7=2, k8=2)
    return counts


def post_npy(url: str, arr: np.ndarray):
    import io
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npy"})
    return urllib.request.urlopen(req, timeout=120)


def serve_clients(url: str, tiles_path: str, out_path: str) -> None:
    """The daemon's clients, in a process of their own (so that they hold
    no lock of the server's interpreter): SERVE_CLIENTS threads POST the
    tiles of ``tiles_path`` one by one, round robin, each waiting for its
    answer before the next request; the responses, per-request latencies,
    wall time and errors go to ``out_path`` (npz)."""
    import io
    import threading

    tiles = np.load(tiles_path)
    n = len(tiles)
    results, lat_s, errors = [None] * n, np.zeros(n), []

    def client(c):
        for i in range(c, n, SERVE_CLIENTS):
            t = time.perf_counter()
            try:
                with post_npy(url, tiles[i]) as r:
                    results[i] = np.load(io.BytesIO(r.read()))
            except (OSError, ValueError) as e:
                errors.append(f"request {i}: {e!r}")
                return
            lat_s[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        errors.append("a request got no answer")
    np.savez(out_path, results=np.stack(results) if not errors else np.zeros(0, np.uint8),
             lat_s=lat_s, wall_s=wall_s, errors=np.array(errors, str))


def serve_phase(model, device):
    """The daemon on the card: build_serving_fn (its warm-up is one batch)
    behind a TileServer on 127.0.0.1, and SERVE_CLIENTS client threads in a
    separate process POSTing SERVE_REQUESTS single tiles, with the launch
    counts at 0. Checks every response against the same tile through the
    serving function in a full batch (<= 1 uint8 step), a 400 for an empty
    batch, and the launch counts. Returns the counts and the number of
    batches."""
    import multiprocessing
    import urllib.error
    import urllib.request

    from mipheivit_tpu_torch.infer import TileServer, build_serving_fn
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE

    tiles = np.random.default_rng(SEED + 6).integers(0, 256, (SERVE_REQUESTS, IMG, IMG, 3),
                                                     dtype=np.uint8)
    reset_counts()
    t0 = time.perf_counter()
    fwd_np = build_serving_fn(model, HOPTIMUS_HE, IMG, SERVE_BATCH, device)
    warm_s = time.perf_counter() - t0
    fwd_s = []

    def timed_fwd(x):                   # the worker's time in the serving function
        t = time.perf_counter()
        y = fwd_np(x)
        fwd_s.append(time.perf_counter() - t)
        return y

    srv = TileServer(timed_fwd, IMG, SERVE_BATCH,
                     channel_names=[f"m{i}" for i in range(MARKERS)], host="127.0.0.1", port=0)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            check(r.status == 200, "[serve] /healthz did not answer 200")
        with tempfile.TemporaryDirectory() as tmp:
            np.save(f"{tmp}/tiles.npy", tiles)
            proc = multiprocessing.get_context("spawn").Process(
                target=serve_clients, args=(base + "/v1/predict", f"{tmp}/tiles.npy",
                                            f"{tmp}/out.npz"))
            proc.start()
            proc.join(timeout=900)
            if proc.is_alive():
                proc.kill()
                proc.join()
            check(proc.exitcode == 0, f"[serve] the client process exited with {proc.exitcode}")
            with np.load(f"{tmp}/out.npz") as z:
                got, lat_s, wall_s, errors = (z["results"], z["lat_s"], float(z["wall_s"]),
                                              list(z["errors"]))
        counts = read_counts()
        stats = srv.batcher.stats()
        try:
            post_npy(base + "/v1/predict", np.zeros((0, IMG, IMG, 3), np.uint8)).close()
            empty_code = 200
        except urllib.error.HTTPError as e:
            empty_code = e.code
    finally:
        srv.stop()
    check(not errors, f"[serve] failed requests: {errors[:3]}")
    want = np.concatenate([fwd_np(tiles[i:i + SERVE_BATCH])
                           for i in range(0, SERVE_REQUESTS, SERVE_BATCH)])
    diff = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
    n_batches = stats["n_batches"] + 1                  # the warm-up batch
    lat = np.sort(lat_s) * 1e3
    print(f"[serve] TileServer at batch {SERVE_BATCH} on 127.0.0.1: {SERVE_REQUESTS} single-tile "
          f"requests from {SERVE_CLIENTS} client threads (another process) in {wall_s:.3f} s = "
          f"{SERVE_REQUESTS / wall_s:.2f} requests/s; client latency p50 "
          f"{lat[len(lat) // 2]:.1f} ms p95 {lat[min(len(lat) - 1, int(len(lat) * 0.95))]:.1f} ms; "
          f"server latency p50 {stats['latency_ms_p50']:.1f} ms p95 {stats['latency_ms_p95']:.1f} ms; "
          f"{stats['n_batches']} batches, occupancy {stats['occupancy']:.3f}, padded rows "
          f"{stats['n_padded_rows']}; serving function {1e3 * np.mean(fwd_s):.1f} ms per batch "
          f"(host clock, upload to fetch), worker busy {sum(fwd_s) / wall_s:.3f} of the wall; "
          f"warm-up {warm_s:.1f} s; {counts_line(counts)} (warm-up counts as a batch); max diff "
          f"to the same tiles in full batches {diff} uint8 step(s) (target <= 1); empty batch "
          f"answered {empty_code} (target 400)", flush=True)
    check(got.shape == (SERVE_REQUESTS, IMG, IMG, MARKERS) and got.dtype == np.uint8,
          f"[serve] responses {got.shape} {got.dtype}")
    check(diff <= 1, f"[serve] responses differ from full batches by {diff}")
    check(empty_code == 400, f"[serve] an empty batch got {empty_code}")
    depth = model.vit_cfg.depth
    check_counts("[serve]", counts, k1=depth * n_batches, k2=depth * n_batches, k3=n_batches)
    return counts, n_batches


def train_batches(n, b, img, device, seed):
    """``n`` microbatches of normalized H&E-like images and mIF targets in
    (-0.9, 0.9), made from a numpy seed and put on the card up front."""
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.standard_normal((b, img, img, 3), dtype=np.float32)
                                       ).to(device),
             "target": torch.from_numpy(rng.uniform(-0.9, 0.9, (b, img, img, MARKERS))
                                        .astype(np.float32)).to(device)} for _ in range(n)]


def train_model(ckpt, enc, img, device, depth=None):
    """The generator for training: per-head decoder, LoRA live, f32 master
    weights; the encoder optionally cut to its first ``depth`` blocks."""
    from mipheivit_tpu_torch.infer import load_generator

    model = load_generator("myvitmatte", "hoptimus0", ckpt, (img, img), MARKERS,
                           dtype=torch.float32, device=device, encoder_ckpt_path=str(enc),
                           fast_heads=False)
    if depth is not None:
        model.encoder.vit.blocks = model.encoder.vit.blocks[:depth]
    return model


def train_setup(model, device, frozen_dtype, grad_checkpointing=False, mesh=None):
    from mipheivit_tpu_torch.train import (build_generator_optimizer, create_train_state,
                                           make_train_step, scaled_lr, weighted_mse_loss)
    from mipheivit_tpu_torch.train.losses import marker_weights_from_stds

    opt = build_generator_optimizer(scaled_lr(LR_G, MICRO * ACCUM), TOTAL_ITERS,
                                    grad_accum_steps=ACCUM)
    state = create_train_state(model, opt, freeze_model_name="myvitmatte",
                               frozen_dtype=frozen_dtype, seed=SEED, device=device,
                               grad_checkpointing=grad_checkpointing, mesh=mesh)
    stds = np.random.default_rng(SEED + 5).uniform(0.1, 0.3, MARKERS)
    loss = weighted_mse_loss(LAMBDA, marker_weights_from_stds(stds))
    return state, make_train_step(model, loss, opt)


def train_phase(name, model, data, n_opt, device, grad_checkpointing=False):
    """Drive the train step over ``n_opt`` optimizer steps of ``ACCUM``
    microbatches with the launch counts at 0; check finite losses, frozen
    weights bit-identical and LoRA and decoder weights moved. Returns the
    launch counts and the steady images/s."""
    from mipheivit_tpu_torch.metrics import PixelMetrics

    t_all = time.perf_counter()
    state, step = train_setup(model, device, torch.bfloat16, grad_checkpointing)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    train0 = {n: p.detach().clone() for n, p in state.gen_params}
    metrics = PixelMetrics.zeros(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, nans, step_s = [], [], []
    for s in range(n_opt):
        t0 = time.perf_counter()
        for a in range(ACCUM):
            state, metrics, log = step(state, data[s * ACCUM + a], metrics)
            losses.append(log["gen_loss"])
            nans.append(log["nan"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    frozen_same = all(torch.equal(p, frozen0[n]) for n, p in model.named_parameters()
                      if not p.requires_grad)
    moved = {n for n, p in state.gen_params if not torch.equal(p.detach(), train0[n])}
    lora_moved = sum(".lora_" in n for n in moved)
    dec_moved = sum(n.startswith("decoder.") for n in moved)
    n_lora = sum(".lora_" in n for n in train0)
    n_dec = sum(n.startswith("decoder.") for n in train0)
    b = data[0]["image"].shape[0]
    steady = float(np.median(step_s[1:])) if len(step_s) > 1 else step_s[0]
    out = metrics.compute()
    print(f"[{name}] {len(losses)} microbatches of {b} x {data[0]['image'].shape[1]} px, "
          f"{n_opt} optimizer steps (accumulation {ACCUM}): optimizer step "
          f"{1e3 * steady:.1f} ms (steps {', '.join(f'{1e3 * s:.1f}' for s in step_s)} ms; "
          f"first includes warm-up) = {ACCUM * b / steady:.2f} images/s; peak memory "
          f"{peak_gb:.2f} GiB; {counts_line(counts)}; loss {', '.join(f'{v:.4f}' for v in losses)}; "
          f"psnr {float(out['psnr']):.3f} ssim {float(out['ssim']):.4f}; frozen bit-identical "
          f"{frozen_same}; moved LoRA {lora_moved}/{n_lora} decoder {dec_moved}/{n_dec} "
          f"({time.perf_counter() - t_all:.1f} s)", flush=True)
    check(all(np.isfinite(losses)) and not any(bool(v) for v in nans), f"{name}: non-finite loss")
    check(frozen_same, f"{name}: a frozen weight changed")
    check(lora_moved == n_lora and dec_moved > 0, f"{name}: trainable weights did not move")
    return counts, ACCUM * b / steady


def one_step_grads(model, batch, device, frozen_dtype=None, mesh=None):
    """Loss and trainable gradients of one microbatch on ``device``: f32, or
    the frozen encoder stored and run in ``frozen_dtype``; over ``mesh``'s
    ranks for a sharded model (the reduced gradients)."""
    from mipheivit_tpu_torch.metrics import PixelMetrics

    state, step = train_setup(model, device, frozen_dtype, mesh=mesh)
    _, _, log = step(state, batch, PixelMetrics.zeros(device))
    return float(log["gen_loss"]), {n: g.detach().float().cpu() for n, g in log["grads"].items()}


def lora_cos(a, b):
    """Cosine between two runs' LoRA q/v gradients: (all tensors taken
    together, the least of one tensor, that tensor's name)."""
    import torch.nn.functional as F

    names = [n for n in a[1] if ".lora_" in n]
    per = {n: float(F.cosine_similarity(a[1][n].double().flatten(), b[1][n].double().flatten(),
                                        0)) for n in names}
    worst = min(per, key=per.get)
    every = F.cosine_similarity(torch.cat([a[1][n].double().flatten() for n in names]),
                                torch.cat([b[1][n].double().flatten() for n in names]), 0)
    return float(every), per[worst], worst


def plain_k5_grads(model, batch, device):
    """``one_step_grads`` of the bf16 step with K5's plain version standing
    in for the kernel (a comparison only; the path never runs it)."""
    from mipheivit_tpu_torch.ops import attention as attn

    kernel = attn._flash_bwd_cuda
    attn._flash_bwd_cuda = attn.flash_backward_reference
    try:
        return one_step_grads(model, batch, device, torch.bfloat16)
    finally:
        attn._flash_bwd_cuda = kernel


def grads_rel(got: dict, want: dict) -> float:
    """The worst norm-relative difference of ``got``'s gradients from
    ``want``'s, over the tensors whose gradient is not ~0."""
    return max(float((got[n] - g).norm() / max(float(g.norm()), 1e-30))
               for n, g in want.items() if float(g.norm()) > 1e-6 * g.numel() ** 0.5)


def compare_grads(card, cpu):
    """(loss relative difference, worst norm-relative gradient difference)."""
    return abs(card[0] - cpu[0]) / abs(cpu[0]), grads_rel(card[1], cpu[1])


def serial_stitch(model, image, tile, overlap, batch, device, dtype=np.uint8):
    """The stitched slide without the pipeline: windows in raster order, the
    same batches padded as the pipeline pads them, the forward and the f32
    codec on the card, then the blend window and the port's
    RollingAccumulator on the host, with no threads. With ``dtype``
    float32 the blended codec values (0-255) before the uint8 cast, which
    truncates them."""
    from mipheivit_tpu_torch.infer.stitch import RollingAccumulator, blend_window
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE

    h, w = image.shape[:2]
    stride = tile - overlap
    locs = [(x, y) for y in range(0, max(h - overlap, 1), stride)
            for x in range(0, max(w - overlap, 1), stride)]
    out = np.zeros((MARKERS, h, w), dtype)
    rolling = RollingAccumulator(out, tile, stride)
    window = blend_window(tile, overlap)
    mean = torch.as_tensor(HOPTIMUS_HE.mean, device=device)
    std = torch.as_tensor(HOPTIMUS_HE.std, device=device)
    padded = np.zeros((h + tile, w + tile, 3), np.uint8)
    padded[:h, :w] = image
    for i in range(0, len(locs), batch):
        chunk = locs[i:i + batch]
        x = np.zeros((batch, tile, tile, 3), np.uint8)
        for j, (tx, ty) in enumerate(chunk):
            x[j] = padded[ty:ty + tile, tx:tx + tile]
        with torch.inference_mode():
            y = model((torch.from_numpy(x).to(device).float() - mean) / std)
            y = (torch.clamp((y.float() + 0.9) / 1.8, 0.0, 1.0) * 255.0).cpu().numpy()
        for pred, (tx, ty) in zip(y, chunk):
            rolling.add(pred, tx, ty, window)
    rolling.finalize()
    return out


def wsi_phase(name, model, image, tile, overlap, batch, device):
    """Drive wsi_inference once with the launch counts at 0, read them, and
    hold the stitched slide against the serial stitch. Returns the counts,
    the pipeline's stats (with the serial stitch before its uint8 cast,
    ``stitch_f32``) and the stitched slide."""
    from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE

    names = [f"m{i}" for i in range(MARKERS)]
    out = np.zeros((MARKERS,) + image.shape[:2], np.uint8)
    stats = {}
    t0 = time.perf_counter()
    reset_counts()
    wsi_inference(model, ArraySlide(image), out, names, HOPTIMUS_HE, tile_size=tile,
                  overlap=overlap, batch_size=batch, tissue_only=False, stats=stats)
    torch.cuda.synchronize()
    counts = read_counts()
    e2e_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    stats["stitch_f32"] = serial_stitch(model, image, tile, overlap, batch, device, np.float32)
    want = stats["stitch_f32"].astype(np.uint8)
    diff = int(np.abs(out.astype(np.int16) - want.astype(np.int16)).max())
    n, steady = stats["n_tiles"], stats["steady_tiles"]
    steady_rate = steady / stats["steady_s"] if stats["steady_s"] > 0 else float("nan")
    mpx = out.shape[1] * out.shape[2] / 1e6
    print(f"[{name}] wsi_inference {out.shape} {out.dtype}: {n} windows of {tile} px in "
          f"{stats['n_batches']} batches of {batch}, wall {stats['wall_s']:.3f} s = "
          f"{n / stats['wall_s']:.2f} windows/s, {mpx / stats['wall_s']:.2f} Mpx/s; steady "
          f"{steady} windows in {stats['steady_s']:.3f} s = {steady_rate:.2f} windows/s; "
          f"read_wait {stats['read_wait_s']:.3f} s device_wait {stats['device_wait_s']:.3f} s "
          f"stitch {stats['stitch_s']:.3f} s finalize {stats['finalize_s']:.3f} s; "
          f"{counts_line(counts)}; serial-stitch max diff "
          f"{diff} uint8 step(s) (target <= 1) ({e2e_s:.1f} s + reference "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)
    check(out.shape == (MARKERS,) + image.shape[:2], f"{name} output shape {out.shape}")
    check(diff <= 1, f"{name}: the stitched slide differs from the serial stitch by {diff}")
    return counts, stats, out


def write_trainer_data(root: Path, seed: int, img: int = IMG, tiles=TRAINER_TILES,
                       nuclei: bool = False) -> dict:
    """``tiles`` tiles of ``img`` px from a numpy seed (H&E uint8 x 3, mIF
    uint8 x 16; with ``nuclei`` int32 nuclei of ``CELL_NUCLEI`` discs, ids
    unique to the slide; a split's tiles alternate between two slides of
    its own) as
    ``.npy`` files, which the port's ``read_image`` decodes with numpy
    alone (TIFF tiles would need libtiff for the native engine, which a
    CUDA host may lack, and PNG tiles cv2), the split CSVs and
    ``channel_stats.json``; returns the config values that point at them."""
    import csv

    rng = np.random.default_rng(seed)
    names = FLAGSHIP_PRESET["data"]["targ_channel_names"]
    root.mkdir()
    values = {}
    n_before = 0
    for split, n in tiles.items():
        rows = []
        for i in range(n):
            image, targ = root / f"{split}{i}.npy", root / f"{split}{i}_mif.npy"
            np.save(image, rng.integers(0, 256, (img, img, 3), dtype=np.uint8))
            np.save(targ, rng.integers(0, 256, (img, img, MARKERS), dtype=np.uint8))
            rows.append({"image_path": str(image), "target_path": str(targ)})
            if nuclei:
                tile = n_before + i
                nuc = root / f"{split}{i}_nuc.npy"
                np.save(nuc, disc_nuclei(rng, 1, img, lambda t, j: 1000 * tile + j + 1)[0])
                rows[-1].update(nuclei_path=str(nuc), in_slide_name=f"{split}{i % 2}")
        n_before += n
        with open(root / f"{split}.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        values[f"data.{split}_dataframe_path"] = str(root / f"{split}.csv")
    stds = rng.uniform(20.0, 60.0, MARKERS)
    stats = {"RGB": {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]},
             **{m: {"idx_channel": i, "std": float(stds[i]), "min": 0, "is_structural": i < 2}
                for i, m in enumerate(names)}}
    (root / "channel_stats.json").write_text(json.dumps(stats))
    values["data.channel_stats_path"] = str(root / "channel_stats.json")
    return values


def trainer_overrides(data_values: dict, ckpt: Path, enc: Path, epochs: int) -> dict:
    """The dotted overrides of the flagship preset for the [trainer] phase:
    the written data, no slide dataframe (so no cell metrics), the smoke's
    checkpoint dir and encoder file, monitor val_gen_loss_sim / min."""
    return {**data_values, "data.slide_dataframe_path": None,
            "model.checkpoint_path": str(ckpt / "model.safetensors"),
            "model.encoder.encoder_weights": str(enc),
            "train.callbacks.modelcheckpoint.monitor": "val_gen_loss_sim",
            "train.callbacks.modelcheckpoint.mode": "min", "train.epochs": epochs}


def trainer_config(overrides: dict):
    from mipheivit_tpu_torch.config import Config

    cfg = Config.create(FLAGSHIP_PRESET)
    for key, value in overrides.items():
        cfg.set_dotted(key, value)
    return cfg


def grad_norms(grads: dict) -> dict:
    """The global norms of a step's LoRA and decoder gradients (the other
    trainable tensors with the decoder), in f64."""
    parts = {"lora": [], "decoder": []}
    for name, g in grads.items():
        parts["lora" if ".lora_" in name else "decoder"].append(g.detach().double().norm())
    return {k: float(torch.stack(v).norm()) for k, v in parts.items()}


def norm_ratio(got: dict, want: dict) -> dict:
    """``got``'s gradient norms over ``want``'s, by part."""
    return {k: got[k] / want[k] for k in want}


def instrument_trainer(trainer, norms: bool = False):
    """Time what the [trainer] phase reports without changing the path:
    wrap the trainer module's ``create_train_state`` (keep copies of the
    frozen and trainable weights as built), ``make_train_step`` (a CUDA event
    behind each step; no sync), ``device_prefetch`` (the host wall time of
    each loop and its loader's statistics), ``save_train_state`` and
    ``restore_train_state`` (seconds), and with ``norms`` each run's first
    step's gradient norms (``grad_norms``, a sync). Returns the records and
    an undo."""
    rec = {"states": [], "events": [], "loops": [], "save_s": [], "restore_s": [],
           "grad_norms": []}
    names = ("create_train_state", "make_train_step", "device_prefetch", "save_train_state",
             "restore_train_state")
    real = {name: getattr(trainer, name) for name in names}

    def create_train_state(*a, **kw):
        state = real["create_train_state"](*a, **kw)
        rec["states"].append((
            {n: p.detach().clone() for n, p in state.generator.named_parameters()
             if not p.requires_grad},
            {n: p.detach().clone() for n, p in state.gen_params}))
        rec["events"].append([])
        return state

    def make_train_step(*a, **kw):
        step = real["make_train_step"](*a, **kw)

        def timed(*args):
            out = step(*args)
            if norms and not rec["events"][-1]:
                rec["grad_norms"].append(grad_norms(out[2]["grads"]))
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            rec["events"][-1].append(event)
            return out

        return timed

    def device_prefetch(loader, **kw):
        t0 = time.perf_counter()
        try:
            yield from real["device_prefetch"](loader, **kw)
        finally:
            rec["loops"].append((loader.pad_to_batch, loader.stats, time.perf_counter() - t0))

    def timed_io(name, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out

        return run

    wrappers = {"create_train_state": create_train_state, "make_train_step": make_train_step,
                "device_prefetch": device_prefetch,
                "save_train_state": timed_io("save_train_state", "save_s"),
                "restore_train_state": timed_io("restore_train_state", "restore_s")}
    for name, fn in wrappers.items():
        setattr(trainer, name, fn)
    return rec, lambda: [setattr(trainer, n, f) for n, f in real.items()]


def trainer_phase(tmp: Path, ckpt: Path, enc: Path, depth: int, train256_rate: float):
    """The training driver on the flagship preset at full width and depth:
    ``train_patchgan`` for 1 epoch of ``TRAINER_STEPS`` microbatches of 8,
    then again with ``resume`` to epoch 2, through K1 and K2 (forward and
    backward terms). Checks finite losses, frozen weights bit-identical,
    LoRA and decoder weights moved, the resumed step, ``status.txt``, the
    step-1 PNG and the exact launch counts. Returns the counts, the config,
    the run's directory, the slower of its two steady rates (images/s) and
    the reference [trainer ddp] is held to (the data's config values, the
    first epoch's mean loss, that rate, the first step's gradient norms)."""
    import mipheivit_tpu_torch.train.trainer as trainer

    t_all = time.perf_counter()
    data = write_trainer_data(tmp / "trainer_data", SEED + 7)
    t_data = time.perf_counter() - t_all
    logdir = tmp / "trainer_run"
    rec, undo = instrument_trainer(trainer, norms=True)
    runs, t_runs = [], []
    try:
        reset_counts()
        for epochs, resume in ((1, False), (2, True)):
            cfg = trainer_config(trainer_overrides(data, ckpt, enc, epochs))
            t0 = time.perf_counter()
            out = trainer.train_patchgan(cfg, str(logdir), max_steps_per_epoch=TRAINER_STEPS,
                                         use_wandb=False, resume=resume)
            torch.cuda.synchronize()
            t_runs.append(time.perf_counter() - t0)
            state = out["state"]
            frozen0, train0 = rec["states"][-1]
            frozen_same = all(torch.equal(p, frozen0[n]) for n, p in
                              state.generator.named_parameters() if not p.requires_grad)
            moved = {n for n, p in state.gen_params if not torch.equal(p.detach(), train0[n])}
            runs.append({"step": state.step, "history": out["history"],
                         "frozen_same": frozen_same and len(frozen0) > 0,
                         "frozen_bf16": all(v.dtype == torch.bfloat16 for v in frozen0.values()
                                            if v.is_floating_point()),
                         "lora": (sum(".lora_" in n for n in moved),
                                  sum(".lora_" in n for n in train0)),
                         "decoder": sum(n.startswith("decoder.") for n in moved)})
            del out, state
            torch.cuda.empty_cache()
        counts = read_counts()
    finally:
        undo()
    status = (logdir / "status.txt").read_text()
    png = (logdir / "logs_img" / "step1.png").exists()
    losses = [h[k] for r in runs for h in r["history"] if "epoch" in h
              for k in ("gen_loss", "gen_loss_sim", "val_gen_loss_sim")]
    # steady rate from the events behind each microbatch: steps 3-4 and 7-8
    # (one optimizer step each; step 1 is followed by the debug grid)
    rates = [2 * 8 * 1000.0 / ev[1].elapsed_time(ev[3]) for ev in rec["events"]]
    train_loops = [(stats, wall) for padded, stats, wall in rec["loops"] if not padded]
    shares = [f"wait {stats.wait_s / wall:.3f} decode {stats.decode_s / wall:.3f} of "
              f"{wall:.2f} s" for stats, wall in train_loops]
    print(f"[trainer] train_patchgan, flagship preset at {IMG} px, {depth} blocks, microbatch 8 x "
          f"accumulation 2, {TRAINER_STEPS} microbatches an epoch: 1 epoch in {t_runs[0]:.1f} s, "
          f"resumed to 2 in {t_runs[1]:.1f} s (data written in {t_data:.1f} s); steady "
          f"{', '.join(f'{r:.2f}' for r in rates)} images/s (one optimizer step, CUDA events "
          f"behind the steps, no sync) vs [train 256] {train256_rate:.2f} images/s "
          f"(ratio {min(rates) / train256_rate:.3f}); train loader {'; '.join(shares)}; "
          f"snapshot write {', '.join(f'{s:.2f}' for s in rec['save_s'])} s, restore "
          f"{', '.join(f'{s:.2f}' for s in rec['restore_s'])} s; steps {runs[0]['step']} -> "
          f"{runs[1]['step']}; losses {', '.join(f'{v:.4f}' for v in losses)}; frozen "
          f"bit-identical {[r['frozen_same'] for r in runs]}, bf16 {runs[0]['frozen_bf16']}; "
          f"moved LoRA {runs[0]['lora'][0]}/{runs[0]['lora'][1]} decoder "
          f"{runs[0]['decoder']}; status {status!r}; step-1 PNG {png}; {counts_line(counts)} "
          f"({time.perf_counter() - t_all:.1f} s)", flush=True)
    check(all(np.isfinite(losses)) and len(losses) == 6, "[trainer] non-finite losses")
    check(all(r["frozen_same"] for r in runs) and runs[0]["frozen_bf16"],
          "[trainer] a frozen weight changed or is not bf16")
    check(runs[0]["lora"][0] == runs[0]["lora"][1] > 0 and runs[0]["decoder"] > 0,
          "[trainer] trainable weights did not move")
    check(runs[0]["step"] == TRAINER_STEPS and runs[1]["step"] == 2 * TRAINER_STEPS
          and len(rec["restore_s"]) == 1, "[trainer] the resumed run did not continue")
    check(status == "finished" and png, "[trainer] status.txt or the step-1 PNG")
    # forwards: 2 x 4 microbatches, the step-1 debug grid, val and test
    # (2 batches each) in both runs; backward terms: the microbatches
    n_val = 2 * (TRAINER_TILES["val"] // 8 + TRAINER_TILES["test"] // 8)
    n_fwd = 2 * TRAINER_STEPS + 1 + n_val
    check_counts("[trainer]", counts, k1=depth * n_fwd, k2=depth * n_fwd,
                 k2b=depth * 2 * TRAINER_STEPS)
    reference = {"data": data, "loss": runs[0]["history"][0]["gen_loss"], "rate": min(rates),
                 "grad_norms": rec["grad_norms"][0]}
    return counts, cfg, logdir, min(rates), reference


def test_driver_phase(cfg, logdir: Path, depth: int):
    """``test_model`` on the [trainer] run's directory (its best
    ``model.safetensors``, loaded by ``load_generator``): val and test pixel
    metrics, finite, through K1 and K2."""
    from mipheivit_tpu_torch.train.test_driver import test_model

    reset_counts()
    t0 = time.perf_counter()
    res = test_model(cfg, str(logdir), logdir.name)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[test driver] test_model on the [trainer] run: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in res.items())}; {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(len(res) == 6 and all(np.isfinite(v) for v in res.values()),
          "[test driver] non-finite metrics")
    n_fwd = TRAINER_TILES["val"] // 8 + TRAINER_TILES["test"] // 8
    check_counts("[test driver]", counts, k1=depth * n_fwd, k2=depth * n_fwd)
    return counts


def disc_nuclei(rng, n_tiles: int, img: int, ids) -> np.ndarray:
    """``[n_tiles, img, img]`` int32 label maps of ``CELL_NUCLEI`` discs a
    tile (radius 4-8 px, later discs over earlier ones); ``ids(t, j)`` is the
    label of tile t's disc j."""
    out = np.zeros((n_tiles, img, img), np.int32)
    for t in range(n_tiles):
        centres = rng.integers(0, img, (CELL_NUCLEI, 2))
        radii = rng.integers(4, 9, CELL_NUCLEI)
        for j, ((cy, cx), r) in enumerate(zip(centres, radii)):
            y0, y1 = max(cy - r, 0), min(cy + r + 1, img)
            x0, x1 = max(cx - r, 0), min(cx + r + 1, img)
            yy, xx = np.ogrid[y0:y1, x0:x1]
            out[t, y0:y1, x0:x1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = ids(t, j)
    return out


def write_mlp(path: Path, n_channels: int, seed: int) -> str:
    """A seeded cluster-MLP checkpoint for the cell loss in the reference's
    layout (``model.{0,1,3,5}.*``: normalisation, 64, 32, n_channels)."""
    g = torch.Generator().manual_seed(seed)
    state = {"model.0.mean": torch.full((n_channels,), 127.5),
             "model.0.std": torch.full((n_channels,), 40.0),
             "model.1.weight": torch.randn(64, n_channels, generator=g) / n_channels ** 0.5,
             "model.1.bias": torch.randn(64, generator=g) * 0.1,
             "model.3.weight": torch.randn(32, 64, generator=g) / 8.0,
             "model.3.bias": torch.randn(32, generator=g) * 0.1,
             "model.5.weight": torch.randn(n_channels, 32, generator=g) / 32 ** 0.5,
             "model.5.bias": torch.randn(n_channels, generator=g) * 0.1}
    torch.save(state, path)
    return str(path)


def segment_pool_phase(dev, tmp: Path):
    """``nucleus_pool`` on the card at CellMetrics' shapes (8 tiles of 256
    px, 15 markers, ~150 disc nuclei a tile with int32 ids up to 2**31 - 1,
    capacity 2048; and capacity 64, fewer slots than labels) against the
    CPU: ids and counts exactly, sums within ``POOL_SUM_RTOL`` of the
    largest; CUDA-event times at 8 and 64 tiles. Then the cell loss (MSE
    and clustering, 16 channels) forward and backward on a microbatch of 8
    under ``set_sync_debug_mode("error")``, against the CPU. Returns the
    pooling ms at 8 and 64 tiles and the loss's forward + backward ms."""
    from mipheivit_tpu_torch.ops.segment_pool import nucleus_pool
    from mipheivit_tpu_torch.train.cell_loss import build_cell_loss

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 200)
    ids = rng.integers(1, 2 ** 31, (8, CELL_NUCLEI))
    ids[0, :3] = 2 ** 31 - 1 - np.arange(3)
    labels = torch.from_numpy(disc_nuclei(rng, 8, IMG, lambda t, j: ids[t, j]))
    values = torch.from_numpy(rng.random((8, IMG, IMG, CELL_MARKERS), dtype=np.float32))
    lines, ms, pool_ok = [], {}, True
    for cap in (POOL_CAPACITY, 64):
        want = nucleus_pool(values, labels, cap)
        got = [t.cpu() for t in nucleus_pool(values.to(dev), labels.to(dev), cap)]
        _, rel, _ = scaled_err(got[1], want[1])
        exact = torch.equal(got[0], want[0]), torch.equal(got[2], want[2])
        lines.append(f"capacity {cap}: ids exact {exact[0]}, counts exact {exact[1]}, sums max "
                     f"err {rel:.2e} of max|ref| (tol {POOL_SUM_RTOL:g}), "
                     f"{int((want[2][:, 1:] > 0).sum())} nuclei kept")
        pool_ok = pool_ok and all(exact) and rel <= POOL_SUM_RTOL
    v8, l8 = values.to(dev), labels.to(dev)
    ms[8] = cuda_ms(lambda: nucleus_pool(v8, l8, POOL_CAPACITY))
    v64, l64 = v8.repeat(8, 1, 1, 1), l8.repeat(8, 1, 1)
    ms[64] = cuda_ms(lambda: nucleus_pool(v64, l64, POOL_CAPACITY))
    del v64, l64

    mlp = write_mlp(tmp / "pool_mlp.ckpt", MARKERS, SEED + 201)
    pred = torch.from_numpy(rng.uniform(-0.9, 0.9, (8, IMG, IMG, MARKERS)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(-0.9, 0.9, (8, IMG, IMG, MARKERS)).astype(np.float32))
    results = {}
    for device in (dev, torch.device("cpu")):
        loss = build_cell_loss(mlp, MARKERS, lambda_factor=LAMBDA, device=device)
        p = pred.to(device).requires_grad_()
        args = (target.to(device), labels.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")    # any host sync raises
        try:
            value = loss(p, *args)
            (grad,) = torch.autograd.grad(value, p)
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        results[device.type] = (value.detach().item(), grad.cpu())
        if device.type == "cuda":
            loss_ms = cuda_ms(lambda: torch.autograd.grad(loss(p, *args), p))
    (v_card, g_card), (v_cpu, g_cpu) = results["cuda"], results["cpu"]
    v_rel = abs(v_card - v_cpu) / abs(v_cpu)
    g_rel = float((g_card - g_cpu).norm() / g_cpu.norm())
    print(f"[segment pool] nucleus_pool at 8 tiles of {IMG} px, {CELL_MARKERS} markers, "
          f"{CELL_NUCLEI} discs a tile: {'; '.join(lines)}; {ms[8]:.3f} ms at 8 tiles, "
          f"{ms[64]:.3f} ms at 64 (CUDA events, median of 20); cell loss (MSE + clustering) "
          f"forward + backward at microbatch 8 with no host sync: {v_card:.6f} vs CPU "
          f"{v_cpu:.6f} (rel {v_rel:.2e}, tol {CELL_LOSS_RTOL:g}), gradient norm-rel {g_rel:.2e} "
          f"(tol {CELL_GRAD_NORM_RTOL:g}), {loss_ms:.3f} ms ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(pool_ok, "[segment pool] nucleus_pool on the card differs from the CPU")
    check(np.isfinite(v_card) and v_rel <= CELL_LOSS_RTOL and g_rel <= CELL_GRAD_NORM_RTOL,
          "[segment pool] the cell loss on the card differs from the CPU")
    return ms, loss_ms


def write_cell_data(root: Path, seed: int, img: int = IMG, tiles=TRAINER_TILES) -> dict:
    """``tiles`` tiles of ``img`` px from a numpy seed as ``.npy`` files (H&E
    uint8 x 3, mIF uint8 x 16, int32 nuclei of ``CELL_NUCLEI`` discs, ids
    unique to the slide), each split's alternating between two slides of
    its own; each slide's nuclei CSV (``label`` and the 15 ``{marker}_pos``
    columns), the slide dataframe, the split CSVs and
    ``channel_stats.json``. Returns the config values that point at them."""
    import csv

    rng = np.random.default_rng(seed)
    names = FLAGSHIP_PRESET["data"]["targ_channel_names"]
    pos_cols = [f"{m}_pos" for m in names if m != "Hoechst"]
    values = write_trainer_data(root, seed, img, tiles, nuclei=True)
    cells = {f"{split}{k}": [] for split in tiles for k in range(2)}
    for split, n in tiles.items():
        for i in range(n):
            labels = np.unique(np.load(root / f"{split}{i}_nuc.npy"))
            slide = f"{split}{i % 2}"
            positive = rng.random((len(labels), len(pos_cols))) < 0.3
            cells[slide] += [[int(lab)] + ["True" if p else "False" for p in row]
                             for lab, row in zip(labels, positive) if lab > 0]
    for slide, rows in cells.items():
        with open(root / f"{slide}_cells.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["label"] + pos_cols)
            writer.writerows(rows)
    with open(root / "slides.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["in_slide_name", "nuclei_csv_path"])
        writer.writerows([[s, str(root / f"{s}_cells.csv")] for s in cells])
    values["data.slide_dataframe_path"] = str(root / "slides.csv")
    return values


def instrument_cell_metrics():
    """Host seconds of ``CellMetrics``' end-of-epoch work without changing
    it: ``update`` (pooling, the one copy to the host, the per-slide
    lists; timed after a sync, so the forward's device time is not in
    it), ``get_dataframe_cell_pred_target`` (the tables), ``train_logistic
    _regression`` (the fit) and ``compute`` (all of it), per call. Returns
    the records and an undo."""
    from mipheivit_tpu_torch.metrics.cell import CellMetrics

    rec = {"update": [], "frames": [], "fit": [], "compute": []}
    names = {"update": "update", "frames": "get_dataframe_cell_pred_target",
             "fit": "train_logistic_regression", "compute": "compute"}
    real = {key: getattr(CellMetrics, name) for key, name in names.items()}

    def timed(key):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[key](self, *a, **kw)
            rec[key].append(time.perf_counter() - t0)
            return out

        return run

    for key, name in names.items():
        setattr(CellMetrics, name, timed(key))
    return rec, lambda: [setattr(CellMetrics, names[k], f) for k, f in real.items()]


def cell_trainer_phase(tmp: Path, ckpt: Path, enc: Path, depth: int, trainer_rate: float):
    """``train_patchgan`` on the flagship preset as it ships (cell metrics on
    a slide dataframe, ``monitor: val_cell_auc``/max) with only the data,
    the checkpoint, the encoder file, the epochs and the cell loss (MSE and
    clustering, a seeded ``mlp.ckpt``) overridden: 1 epoch of
    ``TRAINER_STEPS`` microbatches of 8 (two slides a split). Checks a finite,
    positive ``loss_cell``, a finite ``val_cell_auc`` in ``metrics.jsonl``,
    the export under it, and the exact launches. Returns the counts, the
    config and the run's directory."""
    import mipheivit_tpu_torch.train.trainer as trainer

    t_all = time.perf_counter()
    data = write_cell_data(tmp / "cell_data", SEED + 9)
    t_data = time.perf_counter() - t_all
    logdir = tmp / "cell_run"
    overrides = {**data, "model.checkpoint_path": str(ckpt / "model.safetensors"),
                 "model.encoder.encoder_weights": str(enc), "train.epochs": 1,
                 "train.losses.cell_loss.use_loss": True, "train.losses.cell_loss.use_mse": True,
                 "train.losses.cell_loss.use_clustering": True,
                 "train.losses.cell_loss.mlp_path": write_mlp(tmp / "mlp.ckpt", MARKERS,
                                                              SEED + 202)}
    cfg = trainer_config(overrides)
    rec, undo = instrument_trainer(trainer)
    cell_rec, undo_cells = instrument_cell_metrics()
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = trainer.train_patchgan(cfg, str(logdir), max_steps_per_epoch=TRAINER_STEPS,
                                     use_wandb=False)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = read_counts()
    finally:
        undo()
        undo_cells()
    lines = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    epoch = next(line for line in lines if "epoch" in line)
    ev = rec["events"][0]
    rate = 2 * 8 * 1000.0 / ev[1].elapsed_time(ev[3])
    # validation's compute is the first call, the test split's the second
    val_s = {k: v[0] for k, v in cell_rec.items() if k != "update"}
    n_val_batches = TRAINER_TILES["val"] // 8
    fetch_s = sum(cell_rec["update"][:n_val_batches])
    host_s = fetch_s + val_s["compute"]
    print(f"[cell trainer] train_patchgan, flagship preset as it ships (cell metrics, monitor "
          f"val_cell_auc/max) + the cell loss (MSE + clustering) at {IMG} px, {depth} blocks, "
          f"{TRAINER_STEPS} microbatches of 8, 2 slides a split: 1 epoch in {t_run:.1f} s (data "
          f"written in {t_data:.1f} s); steady {rate:.2f} images/s (one optimizer step, CUDA "
          f"events) vs [trainer] {trainer_rate:.2f} (ratio {rate / trainer_rate:.3f}); loss_cell "
          f"{epoch['loss_cell']:.5f}, gen_loss {epoch['gen_loss']:.5f}; val_cell_auc "
          f"{epoch['val_cell_auc']:.4f} auc_logreg {epoch['val_cell_auc_logreg']:.4f} "
          f"balanced_acc {epoch['val_cell_balanced_acc']:.4f} f1 {epoch['val_cell_f1']:.4f}; "
          f"validation's cell metrics on the host: {host_s:.3f} s = fetch {fetch_s:.3f} s "
          f"({n_val_batches} batches) + compute {val_s['compute']:.3f} s (tables "
          f"{val_s['frames']:.3f} s, fit {val_s['fit']:.3f} s = {val_s['fit'] / host_s:.3f} of "
          f"the host seconds); best {out['best']:.4f}; {counts_line(counts)} "
          f"({time.perf_counter() - t_all:.1f} s)", flush=True)
    check(np.isfinite(epoch["loss_cell"]) and epoch["loss_cell"] > 0,
          "[cell trainer] loss_cell is not finite and positive")
    check(np.isfinite(epoch["val_cell_auc"]) and out["best"] == epoch["val_cell_auc"]
          and (logdir / "model.safetensors").exists()
          and cfg.train.callbacks.modelcheckpoint.monitor == "val_cell_auc",
          "[cell trainer] no export under val_cell_auc")
    check(all(np.isfinite(epoch[k]) for k in ("gen_loss", "gen_loss_sim", "val_gen_loss_sim")),
          "[cell trainer] non-finite losses")
    # forwards: 4 microbatches, the step-1 debug grid, val and test (2
    # batches each); backward terms: the microbatches
    n_fwd = TRAINER_STEPS + 1 + TRAINER_TILES["val"] // 8 + TRAINER_TILES["test"] // 8
    check_counts("[cell trainer]", counts, k1=depth * n_fwd, k2=depth * n_fwd,
                 k2b=depth * TRAINER_STEPS)
    return counts, cfg, logdir, data


def cell_test_driver_phase(cfg, logdir: Path, depth: int):
    """``test_model`` on the [cell trainer] run: cell metrics on val (which
    fits the head), then on test with it, writing
    ``test_dataframe_cell.csv``."""
    from mipheivit_tpu_torch.data.table import Table
    from mipheivit_tpu_torch.train.test_driver import test_model

    reset_counts()
    t0 = time.perf_counter()
    res = test_model(cfg, str(logdir), logdir.name)
    torch.cuda.synchronize()
    counts = read_counts()
    table = Table.read_csv(logdir / "test_dataframe_cell.csv")
    names = [m for m in FLAGSHIP_PRESET["data"]["targ_channel_names"] if m != "Hoechst"]
    columns = (["cell_id"] + [f"{m}_pred" for m in names] + ["slide_name", "label"]
               + [f"{m}_pos" for m in names])
    print(f"[cell test driver] test_model on the [cell trainer] run: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in res.items())}; test_dataframe_cell.csv "
          f"{len(table)} cells x {len(table.columns)} columns; {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(np.isfinite(res["test_cell_auc"]) and all(np.isfinite(v) for v in res.values()),
          "[cell test driver] non-finite metrics")
    check(table.columns == columns and len(table) > 0,
          f"[cell test driver] test_dataframe_cell.csv columns {table.columns}")
    n_fwd = TRAINER_TILES["val"] // 8 + TRAINER_TILES["test"] // 8
    check_counts("[cell test driver]", counts, k1=depth * n_fwd, k2=depth * n_fwd)
    return counts


def eval_phase(module, cfg, logdir: Path, files):
    """One evaluation script's ``run`` on the [cell trainer] checkpoint (the
    fused-heads bf16 forward: K1, K2, K3): its output, launch counts,
    seconds and the ``files`` it did not write."""
    reset_counts()
    t0 = time.perf_counter()
    out = module.run(cfg, str(logdir), batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    counts = read_counts()
    missing = [f for f in files if not (logdir / f).exists()]
    return out, counts, time.perf_counter() - t0, missing


def eval_phases(cfg, logdir: Path, data: dict, tmp: Path, depth: int):
    """[eval orion], [eval immucan] (after orion: its ``logreg.npz``) and
    [eval hemit] (512-px tiles, the forward at 256 px) on the [cell trainer]
    checkpoint. Returns each one's counts."""
    import copy

    from mipheivit_tpu_torch.data.table import Table
    from mipheivit_tpu_torch.evaluation import eval_hemit, eval_immucan, eval_orion

    counts = {}
    # ORION: the val and test tiles
    n_tiles = TRAINER_TILES["val"] + TRAINER_TILES["test"]
    out, counts["eval orion"], secs, missing = eval_phase(
        eval_orion, cfg, logdir,
        ["results_logreg.csv", "cell_dataframe.csv", "logreg.npz", "logreg.pth"])
    results = out["results"]
    print(f"[eval orion] eval_orion.run on the [cell trainer] checkpoint, {n_tiles} tiles at "
          f"batch {EVAL_BATCH}: {len(out['cell_dataframe'])} cells, mean AUC "
          f"{np.mean(results['ROC AUC']):.4f} over {len(results)} markers; missing files "
          f"{missing}; {counts_line(counts['eval orion'])} ({secs:.1f} s)", flush=True)
    check(not missing and len(results) == CELL_MARKERS and np.isfinite(results["ROC AUC"]).all(),
          "[eval orion] results")
    n = -(-n_tiles // EVAL_BATCH)
    check_counts("[eval orion]", counts["eval orion"], k1=depth * n, k2=depth * n, k3=n)

    # IMMUCAN: the test tiles with per-tile ground-truth counts
    test = Table.read_csv(data["data.test_dataframe_path"])
    rng = np.random.default_rng(SEED + 203)
    for marker in ("CD3e", "CD8a", "CD4", "FOXP3", "Pan-CK"):
        test = test.replace(f"{marker}_count", rng.integers(0, 60, len(test)))
    test.to_csv(tmp / "immucan.csv")
    imm_cfg = copy.deepcopy(cfg)
    imm_cfg.data.test_dataframe_path = str(tmp / "immucan.csv")
    out, counts["eval immucan"], secs, missing = eval_phase(
        eval_immucan, imm_cfg, logdir, ["immucan_corr.csv", "immucan_tile_sums.csv"])
    corr = out["corr"]
    print(f"[eval immucan] eval_immucan.run, {len(test)} tiles: Pearson "
          f"{dict(zip(corr['Marker'].tolist(), np.round(corr['Pearson'], 4).tolist()))} over "
          f"{len(out['tile_sums'])} tiles; missing files {missing}; "
          f"{counts_line(counts['eval immucan'])} ({secs:.1f} s)", flush=True)
    check(not missing and len(corr) == 5 and len(out["tile_sums"]) == len(test),
          "[eval immucan] results")
    n = -(-len(test) // EVAL_BATCH)
    check_counts("[eval immucan]", counts["eval immucan"], k1=depth * n, k2=depth * n, k3=n)

    # HEMIT: 512-px tiles, two slides a split, the forward at 256 px
    hemit = write_cell_data(tmp / "hemit_data", SEED + 11, HEMIT_IMG, HEMIT_TILES)
    hemit_cfg = copy.deepcopy(cfg)
    for key, value in hemit.items():
        hemit_cfg.set_dotted(key, value)
    n_tiles = sum(HEMIT_TILES.values())
    out, counts["eval hemit"], secs, missing = eval_phase(
        eval_hemit, hemit_cfg, logdir,
        ["hemit_results_logreg_val.csv", "hemit_results_logreg_test.csv",
         "hemit_cell_dataframe.csv"])
    print(f"[eval hemit] eval_hemit.run, {n_tiles} tiles of {HEMIT_IMG} px (forward at "
          f"{HEMIT_IMG // 2} px): {len(out['cell_dataframe'])} cells, mean AUC val "
          f"{np.nanmean(out['val']['ROC AUC']):.4f} test {np.nanmean(out['test']['ROC AUC']):.4f}; "
          f"missing files {missing}; {counts_line(counts['eval hemit'])} ({secs:.1f} s)",
          flush=True)
    check(not missing and len(out["val"]) == len(out["test"]) == CELL_MARKERS,
          "[eval hemit] results")
    n = -(-n_tiles // EVAL_BATCH)
    check_counts("[eval hemit]", counts["eval hemit"], k1=depth * n, k2=depth * n, k3=n)
    return counts


# ---------------------------------------------------------------------------
# the baseline generators: the UNETR on the ViT encoders and on ResNet-50, the
# SMP U-Net on ConvNeXt-L with its foreground head


def seeded_fill(model, seed: int):
    """Every floating parameter and buffer of ``model`` from a per-name seed,
    drawn on its device and scaled as ``synth_value`` scales them (LoRA B
    non-zero, layer scales at 0.1, BatchNorm statistics off their init)."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            key = int.from_bytes(hashlib.sha256(f"{seed}:{name}".encode()).digest()[:8],
                                 "little") % 2 ** 63
            g = torch.Generator(device=t.device).manual_seed(key)

            def rand(normal=False):
                draw = torch.randn if normal else torch.rand
                return draw(t.shape, generator=g, device=t.device, dtype=torch.float32)

            if "running_var" in name:
                v = rand() + 0.5
            elif "running_mean" in name:
                v = rand(normal=True) * 0.1
            elif name.endswith("gamma"):
                v = (rand() + 0.5) * 0.1
            elif t.dim() == 1 and name.endswith(".weight"):
                v = rand() * 0.2 + 0.9
            else:
                v = rand(normal=True) * 0.02
            t.copy_(v)
    return model


def contrast_head(w: np.ndarray) -> np.ndarray:
    """A marker head's final conv weight ``[1, C, 3, 3]`` made to respond to
    contrast: zero sum over its fan-in, times 25. With ``synth_value``'s
    N(0, 0.02) weights the UNETR's maps sit near a constant set by the
    features' mean (mean |y| ~0.02), with a spatial std of ~3.5e-4, a few
    of bf16's steps at that magnitude (1.2e-4): a bf16-vs-f32 Pearson then
    reads the heads' rounding, not the path, while every stage before them
    stays within bf16's rounding of f32 (measured on an H100).
    ``unetr_rounding_probe`` prints both on every run ([unetr bf16
    probe])."""
    return ((w - w.mean(axis=(1, 2, 3), keepdims=True)) * 25.0).astype(np.float32)


def contrast_heads(model):
    """``contrast_head`` on every marker head of ``model``, in place."""
    with torch.no_grad():
        for name, m in model.named_children():
            if name.startswith("segmentation_head_"):
                w = m[1].weight
                w.copy_(torch.from_numpy(contrast_head(w.float().cpu().numpy())))
    return model


def write_unetr_checkpoint(root: Path, seed: int) -> Path:
    """The ``unet_lora`` preset's checkpoint dir with the foundation encoder
    stripped (LoRA rank 8 adapters, the feature upsampler, the decoder, the
    heads, their final convs through ``contrast_head``), as
    ``save_generator(strip_foundation=True)`` writes it; the encoder is the
    flagship's H-Optimus-0 file (the same timm layout)."""
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.models import get_generator

    shapes = {k: tuple(v.shape) for k, v in get_generator(
        "unet_lora", IMG, MARKERS, "hoptimus0", device="meta").state_dict().items()}
    gen = {name: synth_value(name, shape, seed) for name, shape in shapes.items()
           if not name.startswith("encoder.model.") or ".lora_" in name}
    for name in gen:
        if re.fullmatch(r"segmentation_head_\d+\.1\.weight", name):
            gen[name] = contrast_head(gen[name])
    ckpt = root / "unetr_ckpt"
    ckpt.mkdir()
    save_file(gen, ckpt / "model.safetensors")
    return ckpt


def dtype_probe():
    """Record the input dtype of every K1, K2 and K2-backward launch without
    changing it (wraps the launchers). Returns the record and an undo."""
    from mipheivit_tpu_torch.ops import attention, mlp

    rec = {"k1": set(), "k2": set(), "k2b": set()}
    real = {"k1": (attention, "_attention_cuda"), "k2": (mlp, "_swiglu_cuda"),
            "k2b": (mlp, "_gate_bwd_cuda")}
    saved = {k: getattr(mod, name) for k, (mod, name) in real.items()}

    def wrap(key):
        def run(first, *a, **kw):
            rec[key].add(str(first.dtype).replace("torch.", ""))
            return saved[key](first, *a, **kw)

        return run

    for key, (mod, name) in real.items():
        setattr(mod, name, wrap(key))
    return rec, lambda: [setattr(mod, name, saved[k]) for k, (mod, name) in real.items()]


def card_vs_cpu(model_card, model_cpu, x):
    """The f32 forward on one input on the card and on the CPU (each output
    of a foreground-head model), TF32 off: max |card - CPU|, the worst
    marker's max |card - CPU| over its CPU map's spread max |ref - mean|,
    the least per-marker Pearson, and the CPU outputs' range."""
    with torch.inference_mode():
        a, b = model_card(x), model_cpu(x.cpu())
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    a = [u.cpu().double().flatten(0, -2) for u in a]
    b = [w.double().flatten(0, -2) for w in b]
    diff = max(float((u - w).abs().max()) for u, w in zip(a, b))
    ratio = max(float(((u - w).abs().amax(0) / (w - w.mean(0)).abs().amax(0)).max())
                for u, w in zip(a, b))
    r = min(float(pearson(u.numpy(), w.numpy()).min()) for u, w in zip(a, b))
    lo, hi = min(float(w.min()) for w in b), max(float(w.max()) for w in b)
    return {"diff": diff, "ratio": ratio, "pearson": r, "range": (lo, hi)}


def card_vs_cpu_text(c) -> str:
    return (f"max_abs_diff {c['diff']:.3e} (target <= {F32_CARD_VS_CPU_TOL:g}), "
            f"{c['ratio']:.3e} of the worst marker's spread (target <= {F32_SPREAD_RTOL:g}), "
            f"per-marker Pearson min {c['pearson']:.7f} (target >= {F32_MIN_PEARSON}), "
            f"CPU output in [{c['range'][0]:.4f}, {c['range'][1]:.4f}]")


def check_card_vs_cpu(tag: str, c) -> None:
    check(c["diff"] <= F32_CARD_VS_CPU_TOL and c["ratio"] <= F32_SPREAD_RTOL
          and c["pearson"] >= F32_MIN_PEARSON, f"{tag} f32 card output differs from the CPU")


def unetr_stages(model, x):
    """The UNETR's forward on ``x`` with what each stage gave: the patch
    embedding, each tapped block, the feature upsampler's five maps, the
    decoder and the marker heads' convs before the tanh (all markers)."""
    from mipheivit_tpu_torch.models.unetr import extract_layers_for_depth

    vit = model.encoder.model
    heads = [getattr(model, f"segmentation_head_{k}")[1] for k in range(model.out_chans)]
    mods = {"patch embed": vit.patch_embed.proj,
            **{f"block {i}": vit.blocks[i] for i in extract_layers_for_depth(vit.cfg.depth)},
            "upsampler": model.encoder.feature_upsampler, "decoder": model.decoder,
            **{f"head conv {k}": m for k, m in enumerate(heads)}}
    got = {}
    hooks = [m.register_forward_hook(lambda m, a, out, name=name: got.__setitem__(name, out))
             for name, m in mods.items()]
    try:
        with torch.inference_mode():
            out = model(x).float()
    finally:
        for h in hooks:
            h.remove()
    stages = {k: got[k] for k in mods if k.startswith(("patch", "block"))}
    stages.update((f"upsampler {i}", t) for i, t in enumerate(got["upsampler"]))
    stages["decoder"] = got["decoder"]
    stages["head convs"] = torch.cat([got[f"head conv {k}"] for k in range(len(heads))], 1)
    return {k: v.float() for k, v in stages.items()}, out


def unetr_rounding_probe(model_bf16, model_f32, x, ckpt_seed: int):
    """Why the UNETR's heads go through ``contrast_head`` before its
    bf16-vs-f32 Pearson: on one tile, with the heads' final convs as
    ``synth_value`` draws them (unmodified), each stage's relative bf16
    error (``unetr_stages``), the output's mean and spatial spread beside
    bf16's spacing at that magnitude, and the per-marker Pearson. The heads
    are put back as they were. Returns the least Pearson with the raw heads
    and the stages' errors."""
    heads = [(getattr(model_bf16, f"segmentation_head_{k}")[1].weight,
              getattr(model_f32, f"segmentation_head_{k}")[1].weight)
             for k in range(model_f32.out_chans)]
    kept = [(wb.clone(), wf.clone()) for wb, wf in heads]
    with torch.no_grad():
        for k, (wb, wf) in enumerate(heads):
            raw = torch.from_numpy(synth_value(f"segmentation_head_{k}.1.weight",
                                               tuple(wf.shape), ckpt_seed)).to(wf.device)
            wb.copy_(raw)
            wf.copy_(raw)
    try:
        sb, ob = unetr_stages(model_bf16, x)
        sf, of = unetr_stages(model_f32, x)
    finally:
        with torch.no_grad():
            for (wb, wf), (kb, kf) in zip(heads, kept):
                wb.copy_(kb)
                wf.copy_(kf)
    errs = {k: float((sb[k] - sf[k]).norm() / sf[k].norm()) for k in sf}
    of, ob = of.cpu().numpy(), ob.cpu().numpy()
    mean = max(float(np.abs(of).mean()), 1e-30)
    spread = float(of.reshape(-1, of.shape[-1]).std(0).mean())
    spacing = 2.0 ** (np.floor(np.log2(mean)) - 7)      # bf16: 8 significant bits
    r = pearson(ob, of)
    print(f"[unetr bf16 probe] one tile, heads' final convs as synth_value draws them: bf16 vs "
          f"f32 relative error " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (target <= {BF16_STAGE_RTOL:g}); output mean |y| {mean:.4f}, spatial std "
          f"{spread:.2e} (mean over markers), bf16 spacing at that magnitude {spacing:.2e}; "
          f"per-marker Pearson min {r.min():.5f}, all {np.round(r, 4).tolist()}", flush=True)
    return float(r.min()), errs


def cut_unetr(model, depth: int):
    """A UNETR's encoder cut to its first ``depth`` blocks at full width (its
    taps follow the depth: ``extract_layers_for_depth``)."""
    vit = model.encoder.model
    vit.blocks = vit.blocks[:depth]
    vit.cfg = vit.cfg.replace(depth=depth)
    return model


def unetr_phase(ckpt: Path, ckpt_seed: int, enc: Path, tiles: np.ndarray, dev):
    """[unetr]: the ``unet_lora`` / H-Optimus-0 preset through
    ``load_generator`` -> ``merge_lora`` -> ``cast_params(bf16)``:
    ``predict_tiles`` on the tiles at batch 64 (K1 and K2, in bf16, 40 a
    batch), the steady forward's tiles/s, f32 on the card against the CPU
    at ``UNETR_CUT`` blocks, bf16 against f32 at 40 blocks, and
    ``unetr_rounding_probe``. Returns the launch counts and the rate."""
    from mipheivit_tpu_torch.infer import cast_params, load_generator, merge_lora
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE, predict_tiles
    from mipheivit_tpu_torch.models.unetr import extract_layers_for_depth

    def loaded(device, dtype, depth=None):
        model = load_generator("unet_lora", "hoptimus0", ckpt, (IMG, IMG), MARKERS,
                               device=device, encoder_ckpt_path=str(enc))
        if depth is not None:
            cut_unetr(model, depth)
        return cast_params(merge_lora(model), dtype)

    t0 = time.perf_counter()
    model = loaded(dev, torch.bfloat16)
    depth = model.vit_cfg.depth
    t_load = time.perf_counter() - t0
    probe, undo = dtype_probe()
    try:
        reset_counts()
        out = predict_tiles(model, tiles, HOPTIMUS_HE, BATCH, dev)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        undo()
    n_batches = -(-len(tiles) // BATCH)
    mean = torch.as_tensor(HOPTIMUS_HE.mean, device=dev)
    std = torch.as_tensor(HOPTIMUS_HE.std, device=dev)
    x = (torch.from_numpy(tiles[:BATCH]).to(dev).float() - mean) / std
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        pred_bf16 = model(x[:1]).float().cpu().numpy()
        fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model_f32 = loaded(dev, torch.float32)
    with torch.inference_mode():
        pred_f32 = model_f32(x[:1]).cpu().numpy()
    raw_r, stage_errs = unetr_rounding_probe(model, model_f32, x[:1], ckpt_seed)
    del model, model_f32
    torch.cuda.empty_cache()
    f32 = card_vs_cpu(loaded(dev, torch.float32, UNETR_CUT),
                      loaded("cpu", torch.float32, UNETR_CUT), x[:1])
    torch.cuda.empty_cache()
    r = pearson(pred_bf16, pred_f32)
    rate = BATCH * 1000 / fwd_ms
    print(f"[unetr] unet_lora / hoptimus0 (UnetrViT, {depth} blocks, taps "
          f"{extract_layers_for_depth(depth)}), load_generator + merge_lora + bf16 in {t_load:.1f} s: "
          f"predict_tiles {out.shape} {out.dtype}; {rate:.1f} tiles/s steady bf16 forward at "
          f"batch {BATCH} ({fwd_ms:.2f} ms/batch, CUDA events, median of 10), peak memory "
          f"{peak:.2f} GiB; launch dtypes K1 {sorted(probe['k1'])} K2 {sorted(probe['k2'])}; "
          f"f32 card vs CPU at {UNETR_CUT} blocks {card_vs_cpu_text(f32)}; bf16 vs f32 at "
          f"{depth} blocks (heads through contrast_head) per-marker Pearson min {r.min():.5f} "
          f"(target >= {MIN_PEARSON}; {raw_r:.5f} with the raw heads, [unetr bf16 probe]); "
          f"{counts_line(counts)} on {card_line()}", flush=True)
    check(out.shape == (len(tiles), IMG, IMG, MARKERS) and out.dtype == np.uint8,
          f"[unetr] output {out.shape} {out.dtype}")
    check(probe["k1"] == {"bfloat16"} and probe["k2"] == {"bfloat16"},
          f"[unetr] K1/K2 launched in {probe}, not bf16")
    check_card_vs_cpu("[unetr]", f32)
    check(bool(np.isfinite(pred_bf16).all() and (r >= MIN_PEARSON).all()),
          "[unetr] bf16 output does not track f32")
    check(max(stage_errs.values()) <= BF16_STAGE_RTOL,
          f"[unetr bf16 probe] a stage departs from f32 beyond bf16 rounding: {stage_errs}")
    check_counts("[unetr]", counts, k1=depth * n_batches, k2=depth * n_batches)
    return counts, rate


def fresh_generator(model_name, encoder_name, dev, seed, **kw):
    """A preset's generator at full width on ``dev``, its weights from
    ``seeded_fill``."""
    from mipheivit_tpu_torch.models import get_generator

    return seeded_fill(get_generator(model_name, IMG, MARKERS, encoder_name, device=dev, **kw),
                       seed)


def unetr_encoder_phase(encoder_name, dev, seed):
    """[unetr provgigapath], [unetr univ2], [unetr phikonv2], [unetr sp85m]:
    ``unet_lora`` on a ViT encoder at full width and depth, its weights from
    ``seeded_fill``, heads through ``contrast_head``, LoRA merged: f32 on the
    card against the CPU at ``UNETR_CUT`` blocks (one tile, TF32 off), the
    f32 forward on 4 tiles at full depth, then the bf16 forward at batch 64
    (tiles/s, CUDA events, median of 10; peak memory) against it by
    per-marker Pearson. Checks the geometry (tokens and prefix tokens) and
    the launches: K1 once a block, K2 once a block on a SwiGLU encoder and
    never on a GELU one, both in bf16. Returns the counts and the rate."""
    import copy

    from mipheivit_tpu_torch.infer import cast_params, merge_lora

    t0 = time.perf_counter()
    model = merge_lora(contrast_heads(fresh_generator("unet_lora", encoder_name, dev, seed)))
    cfg = model.vit_cfg
    tokens, prefix, heads, swiglu = ENCODER_GEOMETRY[encoder_name]
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (BATCH, IMG, IMG, 3), dtype=np.float32)).to(dev)
    cut = cut_unetr(copy.deepcopy(model), UNETR_CUT)
    f32_cpu = card_vs_cpu(cut, copy.deepcopy(cut).cpu(), x[:1])
    del cut
    with torch.inference_mode():
        f32 = model(x[:4]).cpu().numpy()
    cast_params(model, torch.bfloat16)
    probe, undo = dtype_probe()
    try:
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            bf16 = model(x)
            torch.cuda.synchronize()
            counts = read_counts()
            bf16 = bf16[:4].float().cpu().numpy()
            fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    torch.cuda.empty_cache()
    r = pearson(bf16, f32)
    tag = f"unetr {encoder_name}"
    rate = BATCH * 1000 / fwd_ms
    print(f"[{tag}] patch {cfg.patch_size}, S {cfg.num_prefix_tokens + cfg.num_patches} "
          f"({cfg.num_prefix_tokens} prefix tokens), {cfg.depth} x {cfg.embed_dim}, "
          f"{cfg.num_heads} heads, {cfg.mlp_type} MLP: bf16 forward at batch {BATCH} "
          f"{fwd_ms:.2f} ms = {rate:.1f} tiles/s (CUDA events, median of 10), peak memory "
          f"{peak:.2f} GiB; launch dtypes K1 {sorted(probe['k1'])} K2 {sorted(probe['k2'])}; f32 "
          f"card vs CPU at {UNETR_CUT} blocks {card_vs_cpu_text(f32_cpu)}; bf16 vs f32 at "
          f"{cfg.depth} blocks per-marker Pearson min {r.min():.5f} (target >= {MIN_PEARSON}); "
          f"{counts_line(counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check((cfg.num_prefix_tokens + cfg.num_patches, cfg.num_prefix_tokens, cfg.num_heads,
           cfg.mlp_type == "swiglu") == (tokens, prefix, heads, swiglu), f"[{tag}] geometry")
    check_card_vs_cpu(f"[{tag}]", f32_cpu)
    check(bool(np.isfinite(bf16).all() and (r >= MIN_PEARSON).all()),
          f"[{tag}] bf16 output does not track f32")
    check(probe["k1"] == {"bfloat16"} and probe["k2"] == ({"bfloat16"} if swiglu else set()),
          f"[{tag}] K1/K2 launched in {probe}")
    check_counts(f"[{tag}]", counts, k1=cfg.depth, k2=cfg.depth if swiglu else 0)
    return counts, rate


def cnn_phase(tag, model_name, encoder_name, dev, seed, foreground_head=False):
    """[smp convnext] / [unet resnet50]: a CNN preset's generator at full
    width: the bf16 forward at batch ``SMP_BATCH`` (tiles/s), f32 on the card
    against the CPU (TF32 off) on one tile, the foreground logits where the
    head is on; no kernel of the port launches."""
    from mipheivit_tpu_torch.infer import cast_params
    from mipheivit_tpu_torch.models import get_generator

    t0 = time.perf_counter()
    model = fresh_generator(model_name, encoder_name, dev, seed, foreground_head=foreground_head)
    cpu = get_generator(model_name, IMG, MARKERS, encoder_name, device="cpu",
                        foreground_head=foreground_head)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (SMP_BATCH, IMG, IMG, 3), dtype=np.float32)).to(dev)
    f32 = card_vs_cpu(model, cpu, x[:1])
    del cpu
    cast_params(model, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    masks, fg = out if foreground_head else (out, None)
    finite = bool(torch.isfinite(masks).all()) and (fg is None or bool(torch.isfinite(fg).all()))
    n_params = sum(p.numel() for p in model.parameters())
    fg_txt = "" if fg is None else (f"; foreground logits {tuple(fg.shape)} in "
                                    f"[{float(fg.min()):.3f}, {float(fg.max()):.3f}]")
    del model, out
    torch.cuda.empty_cache()
    print(f"[{tag}] {model_name} / {encoder_name} ({n_params / 1e6:.1f} M params): bf16 forward "
          f"at batch {SMP_BATCH} {fwd_ms:.2f} ms = {SMP_BATCH * 1000 / fwd_ms:.1f} tiles/s (CUDA "
          f"events, median of 10), peak memory {peak:.2f} GiB; masks {tuple(masks.shape)}{fg_txt}; "
          f"f32 card vs CPU (TF32 off) {card_vs_cpu_text(f32)}; {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(finite and masks.shape == (SMP_BATCH, IMG, IMG, MARKERS), f"[{tag}] output")
    check(foreground_head == (fg is not None) and (fg is None or fg.shape == masks.shape),
          f"[{tag}] foreground head")
    check_card_vs_cpu(f"[{tag}]", f32)
    check_counts(f"[{tag}]", counts)
    return counts, SMP_BATCH * 1000 / fwd_ms


def k2_need_w_ms(dev, m=MICRO * 329):
    """The SwiGLU fc1's backward with fc1 trainable (the UNETR's route: dx,
    dW and db, K2's backward terms inside) and with fc1 frozen (the
    flagship's: dx alone), bf16 at M = ``m``: for each, the device time of
    its kernels (profiler, 20 calls) and the CUDA-event median of 10 calls
    (host autograd work counts there), ms."""
    from mipheivit_tpu_torch.ops.mlp import swiglu_fc1

    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    x = torch.randn(m, FC1_K, generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    w = (torch.randn(2 * FC1_H, FC1_K, generator=g, device=dev) * 0.02)
    b = torch.zeros(2 * FC1_H, device=dev)
    dh = torch.randn(m, FC1_H, generator=g, device=dev).to(torch.bfloat16)
    out = {}
    for need_w in (True, False):
        w.requires_grad_(need_w)
        b.requires_grad_(need_w)
        h = swiglu_fc1(x, w, b)
        wanted = (x, w, b) if need_w else (x,)

        def backward():
            return torch.autograd.grad(h, wanted, dh, retain_graph=True)

        out[need_w] = {"device": device_ms(backward, reps=20),
                       "events": cuda_ms(backward, reps=10)}
    return out[True], out[False]


def family_optimizer(micro: int, vit_lr_decay: bool = False):
    """A baseline preset's generator optimizer at microbatch ``micro`` (no
    accumulation; the schedule past its warm-up at the second step), with
    the trainer's layer decay where ``vit_lr_decay``."""
    from mipheivit_tpu_torch.train import build_generator_optimizer, scaled_lr

    return build_generator_optimizer(scaled_lr(LR_G, micro), TOTAL_ITERS, warmup_iters=1,
                                     vit_lr_decay=vit_lr_decay)


def updates_round_away(state, chain) -> set:
    """The trainable tensors whose last update, ``chain``'s Adam step
    rebuilt from the state's moments, changes no element in f32."""
    opt = state.gen_opt_state
    c1 = float(np.float32(1.0) - np.float32(chain.b1) ** np.float32(opt.adam_count))
    c2 = float(np.float32(1.0) - np.float32(chain.b2) ** np.float32(opt.adam_count))
    size = chain.schedule(opt.schedule_count - 1)
    out = set()
    for (name, p), mu, nu in zip(state.gen_params, opt.mu, opt.nu):
        update = (mu / c1) / ((nu / c2).sqrt() + chain.eps) * size * -chain.lr
        if torch.equal(p.detach() + update, p.detach()):
            out.add(name)
    return out


def family_step(model, model_name, micro, dev, foreground_head=False, mesh=None, disc=None,
                vit_lr_decay=False, compute_dtype=torch.bfloat16):
    """A baseline preset's train state and step (f32 parameters, compute in
    ``compute_dtype``, no accumulation, weighted MSE with the foreground
    term where the head is on), over ``mesh``'s ranks when given. With a
    ``disc`` the GAN step: the PatchGAN discriminator's adversarial term in
    the generator loss and the discriminator's own step, with the
    trainer's discriminator optimizer; ``vit_lr_decay`` gives the generator
    optimizer the trainer's layer decay (the ``unet`` preset's)."""
    from mipheivit_tpu_torch.models.layers import set_compute_dtype
    from mipheivit_tpu_torch.train import (StepConfig, build_discriminator_optimizer,
                                           create_train_state, make_train_step, scaled_lr,
                                           weighted_mse_loss)
    from mipheivit_tpu_torch.train.losses import marker_weights_from_stds

    set_compute_dtype(model, compute_dtype)
    opt = family_optimizer(micro, vit_lr_decay)
    disc_opt = None if disc is None else build_discriminator_optimizer(
        scaled_lr(LR_D, micro), TOTAL_ITERS, warmup_iters=1)
    state = create_train_state(model, opt, disc, disc_opt, freeze_model_name=model_name,
                               seed=SEED, device=dev, mesh=mesh)
    stds = np.random.default_rng(SEED + 5).uniform(0.1, 0.3, MARKERS)
    step = make_train_step(model, weighted_mse_loss(LAMBDA, marker_weights_from_stds(stds)),
                           opt, disc, disc_opt, cfg=StepConfig(gan_train=disc is not None,
                                                               foreground_head=foreground_head))
    return state, step


def train_family_phase(tag, model, model_name, n_micro, micro, dev, foreground_head=False,
                       counted=0, disc=None, vit_lr_decay=False, timed=TRAIN_TIMED_STEPS):
    """[train unetr] / [train convnext fg] / [train ctranspath] / [train
    hemit] and the ablation presets' steps ([train gan …], [train univ2],
    [train unet univ2], [train frozen], [train phikonv2], [train sp85m]):
    ``n_micro`` warm-up microbatches of ``micro`` 256-px tiles through the
    preset's step (``family_step``: no accumulation, so one optimizer step
    each, the first a zero update; f32 parameters, bf16 compute, weighted
    MSE, the foreground term where the head is on, the GAN terms with a
    ``disc``), then ``timed`` more on the same microbatches, each timed
    with CUDA events (the host clock beside them). Checks finite losses,
    every trainable tensor with a gradient moved (and with a ``disc`` every
    discriminator tensor and every spectral ``u``), the trainable count
    against the JAX rule's, and the launches: ``counted`` K1 blocks a
    microbatch, K2 and its backward terms as many where the encoder's MLP is
    SwiGLU. Returns the counts and the rate at the timed steps' median."""
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.train.optim import is_trainable, jax_path

    t_all = time.perf_counter()
    state, step = family_step(model, model_name, micro, dev, foreground_head=foreground_head,
                              disc=disc, vit_lr_decay=vit_lr_decay)
    data = train_batches(n_micro, micro, IMG, dev, SEED + 33)
    n_rule = sum(is_trainable(jax_path(model, n), model_name) for n, _ in model.named_parameters())
    n_all = sum(1 for _ in model.parameters())
    train0 = {n: p.detach().clone() for n, p in state.gen_params}
    disc0 = {} if disc is None else {n: t.detach().clone() for n, t in disc.state_dict().items()}
    metrics = PixelMetrics.zeros(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probe, undo = dtype_probe()
    n_steps = n_micro + timed
    keys = ("gen_loss", "gen_foreground_loss") + (GAN_LOSSES[1:] if disc is not None else ())
    losses, step_s, event_ms, no_grad = [], [], [], set()
    try:
        reset_counts()
        for i in range(n_steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, metrics, log = step(state, data[i % n_micro], metrics)
            end.record()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            event_ms.append(start.elapsed_time(end))
            losses.append({k: float(log[k]) for k in keys})
            no_grad |= {n for n, g in log["grads"].items() if not bool(g.any())}
        counts = read_counts()
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = {n for n, p in state.gen_params if not torch.equal(p.detach(), train0[n])}
    still = sorted(set(train0) - moved - no_grad)
    rounded = []
    if vit_lr_decay:
        # the layer decay scales block i's gradients by 0.65^(40 - i), the
        # embeddings' by 0.65^41: Adam's step on a weight of the first blocks
        # can fall below f32's resolution of the weight, so such a tensor
        # stays put where its last update changes no element (a tensor left
        # out of the update would not)
        rounded = sorted(updates_round_away(state, family_optimizer(micro, True)) & set(still))
        still = sorted(set(still) - set(rounded))
    disc_still = sorted(n for n, t in (disc.state_dict().items() if disc is not None else ())
                        if torch.equal(t, disc0[n]))
    steady = float(np.median(event_ms[n_micro:])) / 1e3
    n_params = sum(p.numel() for _, p in state.gen_params)
    extra = ""
    if disc is not None:
        seen = disc.selected_channels
        extra += (f"; discriminator on {3 + (MARKERS if seen is None else len(seen))} "
                  f"channels (markers {'all' if seen is None else seen}): "
                  + "; ".join(f"{k} " + ", ".join(f"{v[k]:.4f}" for v in losses)
                              for k in GAN_LOSSES[1:])
                  + f"; its tensors and spectral u that did not move: {disc_still}")
    if vit_lr_decay:
        scale = state.gen_opt_state.layer_scale
        extra += (f"; layer decay multipliers {min(scale):.3e} to {max(scale):.3e}; "
                  f"{len(rounded)} tensors whose updates are below f32's resolution stayed "
                  f"{sorted({'.'.join(n.split('.')[:4]) for n in rounded})}")
    print(f"[{tag}] {model_name}, {n_steps} microbatches of {micro} x {IMG} px, one optimizer "
          f"step each: {1e3 * steady:.1f} ms a step (CUDA events, median of the "
          f"{timed} after {n_micro} warm-up steps: "
          f"{', '.join(f'{v:.1f}' for v in event_ms)} ms; host clock "
          f"{', '.join(f'{1e3 * v:.1f}' for v in step_s)} ms) = "
          f"{micro / steady:.2f} images/s; peak memory {peak:.2f} GiB; losses "
          f"{', '.join(f'{v['gen_loss']:.4f}' for v in losses)}, gen_foreground_loss "
          f"{', '.join(f'{v['gen_foreground_loss']:.4f}' for v in losses)}{extra}; trainable "
          f"tensors {len(train0)} ({n_params / 1e6:.1f} M values; the JAX rule's count {n_rule} "
          f"of {n_all}), moved {len(moved)}, no gradient {len(no_grad)} "
          f"{sorted({'.'.join(n.split('.')[:3]) for n in no_grad})}; launch "
          f"dtypes {dict((k, sorted(v)) for k, v in probe.items())}; {counts_line(counts)} "
          f"({time.perf_counter() - t_all:.1f} s)", flush=True)
    check(all(np.isfinite(list(v.values())).all() for v in losses), f"[{tag}] non-finite loss")
    check(all((v["gen_foreground_loss"] > 0) == foreground_head for v in losses),
          f"[{tag}] gen_foreground_loss")
    check(len(train0) == n_rule, f"[{tag}] trains {len(train0)} tensors, the JAX rule {n_rule}")
    check(not still and len(moved) > 0, f"[{tag}] trainable tensors did not move: {still[:5]}")
    check(not disc_still, f"[{tag}] discriminator tensors did not move: {disc_still}")
    if counted:
        check(all(v <= {"bfloat16"} for v in probe.values()), f"[{tag}] launch dtypes {probe}")
    n = counted * n_steps
    n_k2 = n if any(getattr(m, "swiglu", False) for m in model.modules()) else 0
    check_counts(f"[{tag}]", counts, k1=n, k2=n_k2, k2b=n_k2)
    return counts, micro / steady


def trainer_unetr_phase(tmp: Path, ckpt: Path, enc: Path, data: dict, dev, tag="trainer unetr",
                        preset=UNETR_PRESET, unetr_rate=None):
    """[trainer unetr]: ``train_patchgan`` on the ``unetr`` preset as it
    ships (``unet_lora``, train: cell, cell metrics on a slide dataframe,
    monitor val_cell_auc) from the UNETR checkpoint dir: 1 epoch of
    ``TRAINER_STEPS`` microbatches of 8 on the .npy tiles of ``data``.
    Checks finite losses and val_cell_auc, the export loading back through
    ``load_generator``, and the launches. [trainer gan]: the same on the
    ``gan/partial_gan`` preset (the PatchGAN on the structural markers),
    its steady images/s beside [trainer unetr]'s (``unetr_rate``); its
    adversarial losses finite and non-zero. It writes no snapshot and its
    export stripped of the foundation encoder (the released checkpoints'
    layout, reloaded with the encoder file; the export's tensors equal the
    trained ones): the card machine caps a run's disk writes at 45 GiB,
    and [trainer unetr] writes the whole of both. Returns the counts and
    the steady images/s."""
    import mipheivit_tpu_torch.train.trainer as trainer
    from mipheivit_tpu_torch.config import Config
    from mipheivit_tpu_torch.infer import load_generator
    from mipheivit_tpu_torch.train.checkpoints import generator_state_dict

    t_all = time.perf_counter()
    gan = bool(preset["train"]["gan_train"])
    logdir = tmp / tag.replace(" ", "_")
    cfg = Config.create(preset)
    for key, value in {**data, "model.checkpoint_path": str(ckpt / "model.safetensors"),
                       "model.encoder.encoder_weights": str(enc), "train.epochs": 1}.items():
        cfg.set_dotted(key, value)
    real_save = trainer.save_generator, trainer.save_train_state
    if gan:
        trainer.save_train_state = lambda *a, **k: None
        trainer.save_generator = lambda model, path: real_save[0](model, path,
                                                                  strip_foundation=True)
    rec, undo = instrument_trainer(trainer)
    try:
        reset_counts()
        out = trainer.train_patchgan(cfg, str(logdir), max_steps_per_epoch=TRAINER_STEPS,
                                     use_wandb=False)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        undo()
        trainer.save_generator, trainer.save_train_state = real_save
    state = out["state"]
    depth = state.generator.vit_cfg.depth
    n_trainable, n_all = len(state.gen_params), sum(1 for _ in state.generator.parameters())
    trained = generator_state_dict(state.generator, strip_foundation=True) if gan else {}
    disc_in = state.disc.convs[0].weight.shape[1] if gan else 0
    del out, state
    torch.cuda.empty_cache()
    lines = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    epoch = next(line for line in lines if "epoch" in line)
    ev = rec["events"][0]
    rate = 2 * 8 * 1000.0 / ev[1].elapsed_time(ev[3])
    reloaded = load_generator("unet_lora", "hoptimus0", logdir, (IMG, IMG), MARKERS,
                              dtype=torch.bfloat16, device=dev, encoder_ckpt_path=str(enc))
    got = reloaded.state_dict()
    differ = sorted(n for n, v in trained.items()
                    if not torch.equal(got[n].cpu(), torch.from_numpy(v).to(got[n].dtype)))
    x = torch.from_numpy(np.random.default_rng(SEED + 14).standard_normal(
        (2, IMG, IMG, 3), dtype=np.float32)).to(dev)
    reset_counts()
    with torch.inference_mode():
        y = reloaded(x)
    reload_counts = read_counts()
    del reloaded, got
    torch.cuda.empty_cache()
    keys = ("gen_loss", "val_gen_loss_sim", "val_cell_auc") + (GAN_LOSSES[1:] if gan else ())
    extra = ""
    if gan:
        extra = (f" (unetr's {unetr_rate:.2f}); discriminator on {disc_in} channels; "
                 f"gen_adv_loss {epoch['gen_adv_loss']:.5f} disc_adv_loss "
                 f"{epoch['disc_adv_loss']:.5f}; no snapshot, the export stripped of the "
                 f"foundation encoder ({len(trained)} tensors), {len(differ)} of them differ "
                 f"from the trained ones")
    print(f"[{tag}] train_patchgan, {preset['train']['wandb_note']} preset as it ships "
          f"(unet_lora / hoptimus0, {depth} blocks, cell metrics, monitor val_cell_auc/max, "
          f"gan_train {gan}), {TRAINER_STEPS} microbatches of 8 at {IMG} px: "
          f"{time.perf_counter() - t_all:.1f} s; steady {rate:.2f} images/s (CUDA events, two "
          f"steps){extra}; trainable tensors {n_trainable} of {n_all}; gen_loss "
          f"{epoch['gen_loss']:.5f} val_gen_loss_sim {epoch['val_gen_loss_sim']:.5f} "
          f"val_cell_auc {epoch['val_cell_auc']:.4f}; export reloaded through load_generator: "
          f"{tuple(y.shape)}, {counts_line(reload_counts)}; {counts_line(counts)}", flush=True)
    check(all(np.isfinite(epoch[k]) for k in keys), f"[{tag}] non-finite losses or val_cell_auc")
    check(all(epoch[k] != 0 for k in GAN_LOSSES[1:] if gan), f"[{tag}] an adversarial loss is 0")
    check(not differ, f"[{tag}] the export differs from the trained tensors: {differ[:5]}")
    check(n_trainable == n_all, f"[{tag}] the JAX rule trains every tensor of unet_lora")
    check(bool(torch.isfinite(y).all()) and y.shape == (2, IMG, IMG, MARKERS),
          f"[{tag}] the export does not reload")
    check_counts(f"[{tag} reload]", reload_counts, k1=depth, k2=depth)
    n_fwd = TRAINER_STEPS + 1 + TRAINER_TILES["val"] // 8 + TRAINER_TILES["test"] // 8
    check_counts(f"[{tag}]", counts, k1=depth * n_fwd, k2=depth * n_fwd,
                 k2b=depth * TRAINER_STEPS)
    return counts, rate


def gan_discriminator(gan_mode: str, data: dict, dev, seed: int):
    """The trainer's PatchGAN for ``gan_mode`` on ``dev``: on the markers
    that ``trainer.discriminator_channels`` picks from ``data``'s
    ``channel_stats.json`` (``structural``) or on all of them, its weights
    drawn on the CPU from a torch seed."""
    from mipheivit_tpu_torch.data.stats import load_channel_stats
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch
    from mipheivit_tpu_torch.train.trainer import discriminator_channels

    selected = discriminator_channels(gan_mode, load_channel_stats(
        data["data.channel_stats_path"]), FLAGSHIP_PRESET["data"]["targ_channel_names"])
    torch.manual_seed(seed)
    disc = DiscriminatorPatch(3 + (MARKERS if selected is None else len(selected)),
                              selected_channels=selected)
    return disc.to(dev)


def gan_one_step(model, disc, batch, dev, compute_dtype):
    """One GAN step of ``unet_lora`` (``family_step`` with ``disc``) on
    ``batch``, the label noise drawn from a numpy seed, alike on every device
    (the step draws it from the state's generator, which the card and the
    CPU draw otherwise): the losses (``GAN_LOSSES``), the generator's
    gradients, the discriminator's (those its optimizer is handed) and the
    spectral ``u`` after the step."""
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.train import steps
    from mipheivit_tpu_torch.train.optim import AdamChain

    rng = np.random.default_rng(SEED + 90)
    names = {id(p): n for n, p in disc.named_parameters()}
    d_grads = {}
    real_noise, real_step = steps._label_noise, AdamChain.step

    def noise(shape, generator):
        return torch.from_numpy(rng.random(tuple(shape), dtype=np.float32)).to(generator.device)

    def recorded(self, params, grads, *a, **kw):
        if id(params[0]) in names:
            d_grads.update((names[id(p)], g.detach().float().cpu()) for p, g in zip(params, grads))
        return real_step(self, params, grads, *a, **kw)

    steps._label_noise, AdamChain.step = noise, recorded
    try:
        state, step = family_step(model, "unet_lora", len(batch["image"]), dev, disc=disc,
                                  compute_dtype=compute_dtype)
        _, _, log = step(state, batch, PixelMetrics.zeros(dev))
        return ({k: float(log[k]) for k in GAN_LOSSES},
                {n: g.detach().float().cpu() for n, g in log["grads"].items()}, d_grads,
                {n: u.detach().float().cpu() for n, u in disc.named_buffers()})
    finally:
        steps._label_noise, AdamChain.step = real_noise, real_step


def numerics_gan_phase(data: dict, dev):
    """[numerics gan]: the GAN step of ``gan/partial_gan`` (``unet_lora`` on
    H-Optimus-0 at full width, the structural discriminator) on one batch of
    two tiles, f32 on the card (K1, K2 and its backward terms in f32, TF32
    off) against f32 on the CPU (plain versions) with the encoder cut to
    ``UNETR_CUT`` blocks (the UNETR's taps need 4), the same weights and
    label-noise draws on both: the three losses, the generator's and the
    discriminator's gradients and the spectral ``u`` after the step; then
    bf16 against f32 on the card at full depth, the first gen_loss."""
    import copy

    t0 = time.perf_counter()
    model = contrast_heads(fresh_generator("unet_lora", "hoptimus0", dev, SEED + 80))
    disc = gan_discriminator("structural", data, dev, SEED + 81)
    batch = train_batches(1, 2, IMG, dev, SEED + 82)[0]
    cut = cut_unetr(copy.deepcopy(model), UNETR_CUT)
    cpu_model, cpu_disc = copy.deepcopy(cut).cpu(), copy.deepcopy(disc).cpu()
    card = gan_one_step(cut, copy.deepcopy(disc), batch, dev, None)
    del cut
    torch.cuda.empty_cache()
    cpu = gan_one_step(cpu_model, cpu_disc, {k: v.cpu() for k, v in batch.items()}, "cpu", None)
    del cpu_model
    f32 = gan_one_step(copy.deepcopy(model), copy.deepcopy(disc), batch, dev, None)
    torch.cuda.empty_cache()
    bf16 = gan_one_step(model, disc, batch, dev, torch.bfloat16)
    del model
    torch.cuda.empty_cache()
    loss_rel = {k: abs(card[0][k] - cpu[0][k]) / abs(cpu[0][k]) for k in GAN_LOSSES}
    gen_rel, disc_rel = grads_rel(card[1], cpu[1]), grads_rel(card[2], cpu[2])
    u_diff = max(float((card[3][n] - u).abs().max()) for n, u in cpu[3].items())
    bf16_rel = abs(bf16[0]["gen_loss"] - f32[0]["gen_loss"]) / abs(f32[0]["gen_loss"])
    print(f"[numerics gan] f32 card vs f32 CPU at {UNETR_CUT} blocks, the same label noise: "
          + ", ".join(f"{k} {card[0][k]:.6f} vs {cpu[0][k]:.6f} (rel {loss_rel[k]:.2e})"
                      for k in GAN_LOSSES)
          + f" (tol {TRAIN_LOSS_RTOL:g}); worst norm-relative gradient: generator "
          f"{gen_rel:.2e} ({len(cpu[1])} tensors), discriminator {disc_rel:.2e} "
          f"({len(cpu[2])}) (tol {TRAIN_GRAD_NORM_RTOL:g}); spectral u after the step max |diff| "
          f"{u_diff:.2e} (tol {GAN_U_TOL:g}); bf16 vs f32 at full depth: gen_loss "
          f"{bf16[0]['gen_loss']:.6f} vs {f32[0]['gen_loss']:.6f} (rel {bf16_rel:.2e}, tol "
          f"{BF16_LOSS_RTOL:g}), gen_adv_loss {bf16[0]['gen_adv_loss']:.6f} vs "
          f"{f32[0]['gen_adv_loss']:.6f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(all(np.isfinite(list(r[0].values())).all() for r in (card, cpu, f32, bf16)),
          "[numerics gan] non-finite loss")
    check(max(loss_rel.values()) <= TRAIN_LOSS_RTOL and max(gen_rel, disc_rel)
          <= TRAIN_GRAD_NORM_RTOL and u_diff <= GAN_U_TOL,
          "[numerics gan] the f32 GAN step on the card differs from the CPU")
    check(bf16_rel <= BF16_LOSS_RTOL, "[numerics gan] the bf16 GAN step does not track f32")


def ablation_phases(data: dict, dev):
    """The paper's ablation presets' steps at full width and depth, seeded
    weights, each at its preset's microbatch (``ABLATION_PRESETS``): [train
    gan structural] (``gan/partial_gan``: the PatchGAN on the structural
    markers) and [train gan full] (``gan/full_gan``: on all 16; one timed
    step), [numerics gan], [train univ2] (``foundation_models/univ2``),
    [train unet univ2] (``finetuning/full_finetuning``: every tensor
    trains, with the trainer's layer decay), [train frozen]
    (``finetuning/frozen``), and ``unet_lora`` on phikonv2 and sp85m at
    microbatch 8. Returns the launch counts and the rates."""
    counts, numbers = {}, {}

    def run(tag, preset, **kw):
        train, model_cfg = preset["train"], preset["model"]
        name, encoder = model_cfg["model_name"], model_cfg["encoder"]["encoder_name"]
        model = fresh_generator(name, encoder, dev, SEED + 70 + len(counts))
        if train["gan_train"]:
            kw["disc"] = gan_discriminator(train["gan_mode"], data, dev, SEED + 80 + len(counts))
        counts[tag], numbers[f"{tag} images/s"] = train_family_phase(
            tag, model, name, 2, train["batch_size"], dev, counted=model.vit_cfg.depth, **kw)
        del model, kw
        torch.cuda.empty_cache()

    run("train gan structural", ABLATION_PRESETS["gan=partial_gan"])
    run("train gan full", ABLATION_PRESETS["gan=full_gan"], timed=1)
    numerics_gan_phase(data, dev)
    run("train univ2", ABLATION_PRESETS["foundation_models=univ2"])
    # the trainer's rule: a fully trainable ``unet`` ViT takes the layer decay
    run("train unet univ2", ABLATION_PRESETS["finetuning=full_finetuning"], vit_lr_decay=True)
    # as the trainer runs it, without per-block checkpointing (JAX's default
    # remat=True): it fits at batch 16 on an 80-GB H100
    run("train frozen", ABLATION_PRESETS["finetuning=frozen"])
    for name in ("phikonv2", "sp85m"):
        run(f"train {name}", preset_with(ABLATION_PRESETS["foundation_models=univ2"], {
            "train.batch_size": MICRO, "model.encoder.encoder_name": name}))
    return counts, numbers


def baseline_phases(tmp: Path, enc: Path, tiles: np.ndarray, dev):
    """The baseline generators' phases, in order; returns each one's launch
    counts and the numbers the summary reports."""
    counts, numbers = {}, {}
    ckpt = write_unetr_checkpoint(tmp, SEED + 3)
    counts["unetr"], numbers["unetr tiles/s"] = unetr_phase(ckpt, SEED + 3, enc, tiles, dev)
    for i, name in enumerate(("provgigapath",) + ABLATION_ENCODERS):
        counts[f"unetr {name}"], numbers[f"unetr {name} tiles/s"] = unetr_encoder_phase(
            name, dev, SEED + 30 + 2 * i)
    counts["smp convnext"], numbers["smp convnext tiles/s"] = cnn_phase(
        "smp convnext", "smp_unet", "tu-convnext_large", dev, SEED + 40, foreground_head=True)
    counts["unet resnet50"], numbers["unet resnet50 tiles/s"] = cnn_phase(
        "unet resnet50", "unet", "restnet50_lunit_swav", dev, SEED + 50)
    model = fresh_generator("unet_lora", "hoptimus0", dev, SEED + 60)
    depth = model.vit_cfg.depth
    counts["train unetr"], numbers["train unetr images/s"] = train_family_phase(
        "train unetr", model, "unet_lora", 2, MICRO, dev, counted=depth)
    del model
    torch.cuda.empty_cache()
    model = fresh_generator("smp_unet", "tu-convnext_large", dev, SEED + 61, foreground_head=True)
    counts["train convnext fg"], numbers["train convnext images/s"] = train_family_phase(
        "train convnext fg", model, "smp_unet", 2, SMP_BATCH, dev, foreground_head=True)
    del model
    torch.cuda.empty_cache()
    # the cell data of the trainer phases; its channel_stats.json marks the
    # structural markers the GAN ablation's discriminator sees
    data = write_cell_data(tmp / "unetr_data", SEED + 13)
    ablation_counts, ablation = ablation_phases(data, dev)
    counts.update(ablation_counts)
    numbers.update(ablation)
    counts["trainer unetr"], numbers["trainer unetr images/s"] = trainer_unetr_phase(
        tmp, ckpt, enc, data, dev)
    counts["trainer gan"], numbers["trainer gan images/s"] = trainer_unetr_phase(
        tmp, ckpt, enc, data, dev, tag="trainer gan", preset=ABLATION_PRESETS["gan=partial_gan"],
        unetr_rate=numbers["trainer unetr images/s"])
    # last: no timed phase runs after the profiler's trace
    need_w, frozen_w = k2_need_w_ms(dev)
    numbers["k2 need_w device ms"] = need_w["device"]
    print(f"[k2 backward need_w] swiglu_fc1's backward at M {MICRO * 329} bf16, device time "
          f"(profiler, 20 calls) [CUDA events, median of 10]: fc1 trainable (dx, dW, db; the "
          f"UNETR's route) {need_w['device']:.4f} ms [{need_w['events']:.3f}], fc1 frozen (dx; "
          f"the flagship's) {frozen_w['device']:.4f} ms [{frozen_w['events']:.3f}]", flush=True)
    return counts, numbers


# ---------------------------------------------------------------------------
# the Swin models: the ctranspath UNETR, the HEMIT dual-branch generator and
# its zoo, their training, the HEMIT reproduction and the HEMIT-pipeline
# evaluations (no kernel of the port: window attention has a relative-position
# bias, the fusions attend a gathered top-k set)


def topk_agreement(a, b) -> float:
    """Mean share, over the rows, of ``a``'s top-k index set that ``b``'s
    holds (``[B, k]`` each)."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.mean([len(set(u.tolist()) & set(w.tolist())) / len(u) for u, w in zip(a, b)]))


def swin_forward_phase(tag, model_name, encoder_name, batch, dev, seed, contrast=False):
    """[unetr ctranspath] / [hemit]: a preset's generator at full width
    (seeded weights; the UNETR's heads through ``contrast_head``): f32 on
    the card against the CPU (TF32 off) on one tile, the f32 forward of 4
    tiles on the card, then bf16: its forward at ``batch`` (tiles/s, CUDA
    events, median of 10), peak memory, per-marker Pearson against f32 on
    the 4 tiles; for the HEMIT generator the top-k sets of each fusion, f32
    card vs CPU and bf16 vs f32. No kernel launches."""
    from mipheivit_tpu_torch.infer import cast_params
    from mipheivit_tpu_torch.models import get_generator

    t0 = time.perf_counter()
    model = fresh_generator(model_name, encoder_name, dev, seed)
    if contrast:
        contrast_heads(model)
    cpu = get_generator(model_name, IMG, MARKERS, encoder_name, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (batch, IMG, IMG, 3), dtype=np.float32)).to(dev)
    atts = getattr(model, "cross_atts", [])
    f32 = card_vs_cpu(model, cpu, x[:1])
    sets = [topk_agreement(a.last_indices, c.last_indices) for a, c in zip(atts, cpu.cross_atts)
            ] if atts else []
    del cpu
    with torch.inference_mode():
        ref = model(x[:4]).cpu().numpy()
    ref_idx = [a.last_indices for a in atts]
    cast_params(model, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bf16_sets = [topk_agreement(r, a.last_indices[:4]) for r, a in zip(ref_idx, atts)]
    finite = bool(torch.isfinite(out).all())
    r = pearson(out[:4].float().cpu().numpy(), ref)
    n_params = sum(p.numel() for p in model.parameters())
    del model, out
    torch.cuda.empty_cache()
    rate = batch * 1000 / fwd_ms
    sets_txt = "" if not sets else (
        f"; top-k sets (k {', '.join(str(int(i.shape[1])) for i in ref_idx)}) f32 card vs CPU "
        f"{', '.join(f'{v:.4f}' for v in sets)}, bf16 vs f32 {', '.join(f'{v:.4f}' for v in bf16_sets)}")
    print(f"[{tag}] {model_name}{'' if encoder_name is None else ' / ' + encoder_name} "
          f"({n_params / 1e6:.1f} M params): bf16 forward at batch {batch} {fwd_ms:.2f} ms = "
          f"{rate:.1f} tiles/s (CUDA events, median of 10), peak memory {peak:.2f} GiB; f32 card "
          f"vs CPU (TF32 off) {card_vs_cpu_text(f32)}; bf16 vs f32 per-marker Pearson min "
          f"{r.min():.5f} (target >= {MIN_PEARSON}){sets_txt}; {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(finite, f"[{tag}] non-finite bf16 output")
    check_card_vs_cpu(f"[{tag}]", f32)
    check(bool((r >= MIN_PEARSON).all()), f"[{tag}] bf16 output does not track f32")
    check_counts(f"[{tag}]", counts)
    return counts, {"tiles/s": rate, "peak GiB": peak}


def hemit_zoo_phase(dev):
    """[hemit zoo]: each other netG of ``build_hemit_netG`` at 256 px and
    full width, seeded weights: f32 on the card against the CPU (TF32 off)
    at batch ``ZOO_BATCH``, each held as the other phases are
    (``check_card_vs_cpu``: max |diff|, the worst marker's spread and
    per-marker Pearson). No kernel launches."""
    from mipheivit_tpu_torch.models.hemit import build_hemit_netG

    t0 = time.perf_counter()
    x = torch.from_numpy(np.random.default_rng(SEED + 91).standard_normal(
        (ZOO_BATCH, IMG, IMG, 3), dtype=np.float32)).to(dev)
    lines, results, total = [], {}, {k: 0 for k in read_counts()}
    for i, net in enumerate(ZOO_NETGS):
        with torch.device(dev):
            model = seeded_fill(build_hemit_netG(net, IMG, 3, MARKERS), SEED + 92 + i).eval()
        cpu = build_hemit_netG(net, IMG, 3, MARKERS).eval()
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        reset_counts()
        c = card_vs_cpu(model, cpu, x)
        counts = read_counts()
        total = {k: total[k] + counts[k] for k in total}
        lines.append(f"{net} ({type(model).__name__}, "
                     f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M) "
                     f"{card_vs_cpu_text(c)}")
        results[net] = c
        del model, cpu
        torch.cuda.empty_cache()
    print(f"[hemit zoo] f32 card vs CPU (TF32 off) at batch {ZOO_BATCH}, {IMG} px, {MARKERS} "
          f"outputs: {'; '.join(lines)}; {counts_line(total)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for net, c in results.items():
        check_card_vs_cpu(f"[hemit zoo {net}]", c)
    check_counts("[hemit zoo]", total)
    return total


def trainer_hemit_phase(tmp: Path, dev):
    """[trainer hemit]: ``train_patchgan`` on ``default_configs/hemit.yaml``
    as it ships (cell metrics on a slide dataframe, monitor val_cell_auc,
    batch 4) on the [cell trainer]'s kind of data: 1 epoch of
    ``TRAINER_STEPS`` microbatches, then ``test_model`` on the export
    (loaded as the trainer wrote it). Checks finite losses and
    val_cell_auc, every tensor trainable, finite test metrics, no launch."""
    import mipheivit_tpu_torch.train.trainer as trainer
    from mipheivit_tpu_torch.config import Config
    from mipheivit_tpu_torch.train.test_driver import test_model

    t_all = time.perf_counter()
    data = write_cell_data(tmp / "hemit_trainer_data", SEED + 84)
    logdir = tmp / "hemit_run"
    cfg = Config.create(HEMIT_PRESET)
    for key, value in {**data, "train.epochs": 1}.items():
        cfg.set_dotted(key, value)
    rec, undo = instrument_trainer(trainer)
    try:
        reset_counts()
        out = trainer.train_patchgan(cfg, str(logdir), max_steps_per_epoch=TRAINER_STEPS,
                                     use_wandb=False)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        undo()
    state = out["state"]
    n_trainable, n_all = len(state.gen_params), sum(1 for _ in state.generator.parameters())
    del out, state
    torch.cuda.empty_cache()
    lines = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    epoch = next(line for line in lines if "epoch" in line)
    ev = rec["events"][0]
    b = HEMIT_PRESET["train"]["batch_size"]
    rate = 2 * b * 1000.0 / ev[1].elapsed_time(ev[3])
    reset_counts()
    t0 = time.perf_counter()
    res = test_model(cfg, str(logdir), logdir.name)
    torch.cuda.synchronize()
    test_counts = read_counts()
    t_test = time.perf_counter() - t0
    total = {k: counts[k] + test_counts[k] for k in counts}
    print(f"[trainer hemit] train_patchgan, hemit preset as it ships (ResnetGeneratorSwinT, cell "
          f"metrics, monitor val_cell_auc/max), {TRAINER_STEPS} microbatches of {b} at {IMG} px: "
          f"steady {rate:.2f} images/s (CUDA events, two steps); trainable tensors {n_trainable} "
          f"of {n_all}; gen_loss {epoch['gen_loss']:.5f} val_gen_loss_sim "
          f"{epoch['val_gen_loss_sim']:.5f} val_cell_auc {epoch['val_cell_auc']:.4f}; then "
          f"test_model on the export in {t_test:.1f} s: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in res.items() if not k.startswith('val_cell_'))}; "
          f"{counts_line(total)} ({time.perf_counter() - t_all:.1f} s)", flush=True)
    check(all(np.isfinite(epoch[k]) for k in ("gen_loss", "val_gen_loss_sim", "val_cell_auc")),
          "[trainer hemit] non-finite losses or val_cell_auc")
    check((logdir / "model.safetensors").exists() and n_trainable == n_all,
          "[trainer hemit] export, or the JAX rule's trainable set")
    check(all(np.isfinite(v) for v in res.values()) and "test_cell_auc" in res,
          "[trainer hemit] test_model")
    check_counts("[trainer hemit]", total)
    return total, rate


def train_hemit_phase(tmp: Path, dev):
    """[train_hemit]: ``python -m mipheivit_tpu_torch.hemit.train_hemit``'s
    ``main`` for 1 epoch (GAN + L1 x 100) on ``HEMIT_PAIRS`` seeded ``.npy``
    pairs of 256 px in HEMIT's folder layout, batch 4; its best-val_psnr
    snapshot reloaded into a fresh train state. No kernel launches."""
    from mipheivit_tpu_torch.hemit import train_hemit
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch
    from mipheivit_tpu_torch.models.hemit import build_hemit
    from mipheivit_tpu_torch.train import (build_discriminator_optimizer,
                                           build_generator_optimizer, create_train_state)
    from mipheivit_tpu_torch.train.checkpoints import restore_train_state

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 88)
    root = tmp / "hemit_pairs"
    for split, n in HEMIT_PAIRS.items():
        for sub in ("input", "label"):
            (root / split / sub).mkdir(parents=True)
            for i in range(n):
                np.save(root / split / sub / f"{split}{i}.npy",
                        rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8))
    reset_counts()
    t_run = time.perf_counter()
    out = train_hemit.main(["--data_root", str(root), "--out_dir", str(tmp / "train_hemit"),
                            "--epochs", "1", "--batch_size", "4", "--crop", str(IMG)])
    torch.cuda.synchronize()
    counts = read_counts()
    t_run = time.perf_counter() - t_run
    state = out["state"]
    with torch.device(dev):
        fresh = create_train_state(build_hemit(IMG, 3, 3), build_generator_optimizer(2e-4, 2),
                                   DiscriminatorPatch(6), build_discriminator_optimizer(2e-4, 2),
                                   device=dev)
    restore_train_state(out["best_path"], fresh)
    same = all(torch.equal(p, q) for p, q in zip(fresh.generator.state_dict().values(),
                                                 state.generator.state_dict().values()))
    vm = out["history"][0]
    del out, state, fresh
    torch.cuda.empty_cache()
    print(f"[train_hemit] train_hemit.main, 1 epoch of {HEMIT_PAIRS['train']} pairs at batch 4 "
          f"(GAN + L1 x 100) and {HEMIT_PAIRS['val']} validation pairs in {t_run:.1f} s: "
          f"val_psnr {vm['val_psnr']:.4f} val_ssim {vm['val_ssim']:.4f}; the snapshot in best/ "
          f"reloaded into a fresh state, generator equal {same}; {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(np.isfinite(vm["val_psnr"]) and same, "[train_hemit] metrics or the snapshot")
    check_counts("[train_hemit]", counts)
    return counts


def hemit_checkpoint(root: Path, dev, seed: int) -> Path:
    """A HEMIT-codebase ``latest_net_G.pth`` of the dual-branch generator at
    256 px (seeded weights; the Swin branch in the older timm layout, each
    stage's downsample at the end of the stage before, with its index
    buffers, under Lightning's ``generator.`` prefix)."""
    state = fresh_generator("hemit", None, dev, seed).state_dict()
    out = {}
    for k, v in state.items():
        if k.startswith("swinT.layers.") and ".downsample." in k:
            parts = k.split(".")
            parts[2] = str(int(parts[2]) - 1)
            k = ".".join(parts)
        if k.endswith("relative_position_bias_table"):
            out["generator." + k.replace("bias_table", "index")] = torch.zeros(1, dtype=torch.long)
        out["generator." + k] = v.cpu()
    root.mkdir()
    torch.save(out, root / "latest_net_G.pth")
    torch.cuda.empty_cache()
    return root


def hemit_pipeline_phases(tmp: Path, dev):
    """[eval orion|immucan|hemit hemit pipeline]: each HEMIT-pipeline
    script's ``run`` on a HEMIT-codebase checkpoint (``hemit_checkpoint``),
    the hemit preset's config over seeded cell data: ORION on 256-px val and
    test tiles, IMMUCAN (after ORION: its ``logreg.npz``) on the test tiles
    with per-tile counts, HEMIT on 512-px tiles with the generator built at
    256. Checks the CSVs and no launch. Returns each one's counts."""
    import copy

    from mipheivit_tpu_torch.config import Config
    from mipheivit_tpu_torch.data.table import Table
    from mipheivit_tpu_torch.evaluation import (eval_hemit_hemit_pipeline,
                                                eval_immucan_hemit_pipeline,
                                                eval_orion_hemit_pipeline)

    ckpt = hemit_checkpoint(tmp / "hemit_ckpt", dev, SEED + 86)
    data = write_cell_data(tmp / "hemit_eval_data", SEED + 87, IMG, HEMIT_EVAL_TILES)
    cfg = Config.create(HEMIT_PRESET)
    for key, value in data.items():
        cfg.set_dotted(key, value)
    counts, lines, ok = {}, [], True

    out, counts["eval orion hemit pipeline"], secs, missing = eval_phase(
        eval_orion_hemit_pipeline, cfg, ckpt,
        ["results_logreg.csv", "cell_dataframe.csv", "logreg.npz"])
    results = out["results"]
    lines.append(f"[eval orion hemit pipeline] {len(out['cell_dataframe'])} cells, mean AUC "
                 f"{np.mean(results['ROC AUC']):.4f} over {len(results)} markers, missing "
                 f"{missing}, {secs:.1f} s")
    ok = ok and not missing and len(results) == CELL_MARKERS

    test = Table.read_csv(data["data.test_dataframe_path"])
    rng = np.random.default_rng(SEED + 204)
    for marker in ("CD3e", "CD8a", "CD4", "FOXP3", "Pan-CK"):
        test = test.replace(f"{marker}_count", rng.integers(0, 60, len(test)))
    test.to_csv(tmp / "hemit_immucan.csv")
    imm_cfg = copy.deepcopy(cfg)
    imm_cfg.data.test_dataframe_path = str(tmp / "hemit_immucan.csv")
    out, counts["eval immucan hemit pipeline"], secs, missing = eval_phase(
        eval_immucan_hemit_pipeline, imm_cfg, ckpt, ["immucan_corr.csv", "immucan_tile_sums.csv"])
    lines.append(f"[eval immucan hemit pipeline] Pearson over {len(out['tile_sums'])} tiles "
                 f"{dict(zip(out['corr']['Marker'].tolist(), np.round(out['corr']['Pearson'], 4).tolist()))}, "
                 f"missing {missing}, {secs:.1f} s")
    ok = ok and not missing and len(out["corr"]) == 5

    hemit = write_cell_data(tmp / "hemit_eval_512", SEED + 89, HEMIT_IMG, HEMIT_TILES)
    hemit_cfg = copy.deepcopy(cfg)
    for key, value in hemit.items():
        hemit_cfg.set_dotted(key, value)
    out, counts["eval hemit hemit pipeline"], secs, missing = eval_phase(
        eval_hemit_hemit_pipeline, hemit_cfg, ckpt,
        ["hemit_results_logreg_val.csv", "hemit_results_logreg_test.csv"])
    lines.append(f"[eval hemit hemit pipeline] {len(out['cell_dataframe'])} cells of "
                 f"{sum(HEMIT_TILES.values())} tiles of {HEMIT_IMG} px (the generator at "
                 f"{HEMIT_IMG // 2} px), mean AUC val {np.nanmean(out['val']['ROC AUC']):.4f} "
                 f"test {np.nanmean(out['test']['ROC AUC']):.4f}, missing {missing}, "
                 f"{secs:.1f} s")
    ok = ok and not missing and len(out["val"]) == len(out["test"]) == CELL_MARKERS
    for line, (name, c) in zip(lines, counts.items()):
        print(f"{line}; {counts_line(c)}", flush=True)
        check_counts(f"[{name}]", c)
    check(ok, "[eval * hemit pipeline] results")
    return counts


def swin_phases(tmp: Path, dev):
    """The Swin models' phases, in order; returns each one's launch counts
    and the numbers the summary reports."""
    counts, numbers = {}, {}
    counts["unetr ctranspath"], n = swin_forward_phase(
        "unetr ctranspath", "unet_lora", "ctranspath", CTRANSPATH_BATCH, dev, SEED + 70,
        contrast=True)
    numbers.update({f"unetr ctranspath {k}": v for k, v in n.items()})
    counts["hemit"], n = swin_forward_phase("hemit", "hemit", None, HEMIT_BATCH, dev, SEED + 80)
    numbers.update({f"hemit {k}": v for k, v in n.items()})
    counts["hemit zoo"] = hemit_zoo_phase(dev)
    for tag, name, enc, micro, seed in (("train ctranspath", "unet_lora", "ctranspath",
                                         CTRANSPATH_PRESET["train"]["batch_size"], SEED + 72),
                                        ("train hemit", "hemit", None,
                                         HEMIT_PRESET["train"]["batch_size"], SEED + 82)):
        model = fresh_generator(name, enc, dev, seed)
        counts[tag], numbers[f"{tag} images/s"] = train_family_phase(tag, model, name, 2, micro,
                                                                     dev)
        del model
        torch.cuda.empty_cache()
    counts["trainer hemit"], numbers["trainer hemit images/s"] = trainer_hemit_phase(tmp, dev)
    counts["train_hemit"] = train_hemit_phase(tmp, dev)
    counts.update(hemit_pipeline_phases(tmp, dev))
    return counts, numbers


# ---------------------------------------------------------------------------
# preprocessing: Cellpose nuclei segmentation, H&E nuclei, the CycleGAN stain
# normaliser, the trainer's profiler hook and the TIFF engine (no kernel of
# the port on these paths: K1-K8 = 0, except [trainer profile], the flagship
# trainer)

CELLPOSE_NBASE = (2, 32, 64, 128, 256)   # cellpose's nuclei model, full width
CELLPOSE_BATCH = 64
CELLPOSE_TILE = 224
CELLPOSE_TOL = 1e-4              # max |card - CPU| / max |CPU|, f32, TF32 off
NUCLEI_SLIDE = 2048              # [nuclei wsi]: a blob-DAPI slide of 2048^2 at 0.325 mpp
NUCLEI_TILE = 1024
NUCLEI_HALO = 128
NUCLEI_BLOBS = 4000              # discs of radius 6-9 px on the slide: ~17 % of it
NUCLEI_DENSITY = NUCLEI_BLOBS / NUCLEI_SLIDE ** 2
NUCLEI_FIT_STEPS = 300           # the CPnet fitted to masks_to_flows of blob tiles first
NUCLEI_FIT_BATCH = 8
NUCLEI_FIT_TILES = 32
NUCLEI_FIT_LR = 1e-3
HE_SLIDE = 2048
CYCLE_BATCH = 4
CYCLE_IMG = 512
CYCLE_TOL = 1e-3                 # max |card - CPU| of the tanh output, f32, TF32 off
CYCLE_SLIDE = (1536, 1024)       # [cycle gan] slide (w, h): 6 tiles of 512, 2 batches
PROFILE_STEPS = 2


def cellpose_state(seed: int) -> dict:
    """A cellpose CPnet state dict at full width from a numpy seed: convs
    and linears N(0, 2 / fan_in), BN weights near 1, running variances in
    [0.7, 1.2], diameters 30 and 17 (a rescale of 30/17)."""
    from mipheivit_tpu_torch.models.cellpose_net import CPnet

    g = np.random.default_rng(seed)
    out = {}
    for k, v in CPnet(CELLPOSE_NBASE).state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros((), np.int64)
        elif k in ("diam_mean", "diam_labels"):
            out[k] = np.full((1,), 30.0 if k == "diam_mean" else 17.0, np.float32)
        elif k.endswith("running_var"):
            out[k] = g.uniform(0.7, 1.2, v.shape).astype(np.float32)
        elif v.dim() > 1:
            fan_in = int(np.prod(v.shape[1:]))
            out[k] = (g.standard_normal(v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        elif k.endswith(".0.weight"):          # the BatchNorms' scales
            out[k] = (1.0 + 0.1 * g.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (0.1 * g.standard_normal(v.shape)).astype(np.float32)
    return out


def cellpose_phase(dev):
    """[cellpose]: CPnet at (2, 32, 64, 128, 256) on a batch of 64 tiles of
    224^2 in f32 (channels_last), held against the plain CPU forward of the
    same module on 2 tiles."""
    from mipheivit_tpu_torch.models.cellpose_net import build_cpnet

    t0 = time.perf_counter()
    state = cellpose_state(SEED + 200)
    model = build_cpnet(state, device=dev)
    g = np.random.default_rng(SEED + 201)
    x = np.zeros((CELLPOSE_BATCH, 2, CELLPOSE_TILE, CELLPOSE_TILE), np.float32)
    x[:, 0] = g.random((CELLPOSE_BATCH, CELLPOSE_TILE, CELLPOSE_TILE))
    xd = torch.from_numpy(x).to(dev).contiguous(memory_format=torch.channels_last)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        y, style = model(xd)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: model(xd), reps=10, warmup=2)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.inference_mode():
        yc, sc = build_cpnet(state, device="cpu")(torch.from_numpy(x[:2]))
    rel = float((y[:2].cpu() - yc).abs().max() / yc.abs().max())
    rel_style = float((style[:2].cpu() - sc).abs().max() / sc.abs().max())
    print(f"[cellpose] CPnet {CELLPOSE_NBASE} f32 channels_last, batch {CELLPOSE_BATCH} x "
          f"{CELLPOSE_TILE}^2: {ms:.2f} ms/batch ({CELLPOSE_BATCH * 1000 / ms:.1f} tiles/s, CUDA "
          f"events, median of 10), peak {peak:.2f} GiB; card vs CPU on 2 tiles: y {rel:.2e}, "
          f"style {rel_style:.2e} of max|CPU| (tol {CELLPOSE_TOL:g}); {counts_line(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(bool(torch.isfinite(y).all()) and y.shape == (CELLPOSE_BATCH, 3, CELLPOSE_TILE,
                                                        CELLPOSE_TILE), "[cellpose] output")
    check(rel <= CELLPOSE_TOL and rel_style <= CELLPOSE_TOL,
          "[cellpose] the card's CPnet differs from the CPU's")
    check_counts("[cellpose]", counts)
    del model
    return counts, state


def blob_slide(rng, side: int, n: int, background, blob, labels: bool = False):
    """``[C, side, side]`` uint8: ``background`` with ``n`` discs of radius
    6-9 px in ``blob`` colour, plus noise of 8 levels; with ``labels``, also
    the ``[side, side]`` int32 plane of the discs (a later disc over an
    earlier one, as painted)."""
    img = np.empty((len(background), side, side), np.uint8)
    for c, v in enumerate(background):
        img[c] = v
    lab = np.zeros((side, side), np.int32)
    yy, xx = np.ogrid[:side, :side]
    for i, (cy, cx, r) in enumerate(zip(rng.integers(10, side - 10, n),
                                        rng.integers(10, side - 10, n),
                                        rng.integers(6, 10, n))):
        y0, y1, x0, x1 = cy - r, cy + r + 1, cx - r, cx + r + 1
        disc = (yy[y0:y1] - cy) ** 2 + (xx[:, x0:x1] - cx) ** 2 <= r * r
        for c, v in enumerate(blob):
            img[c, y0:y1, x0:x1][disc] = v
        lab[y0:y1, x0:x1][disc] = i + 1
    noise = rng.integers(0, 8, img.shape, dtype=np.uint8)
    img = np.where(img > 247, img, img + noise).astype(np.uint8)
    return (img, lab) if labels else img


def fit_cpnet_to_blobs(model, rng, steps: int, batch: int, n_tiles: int, tile: int = 224):
    """Fit ``model`` (train mode, Adam) to Cellpose's training target on
    blob tiles made as the [nuclei wsi] slide is (NUCLEI_DENSITY discs per
    px^2), seen as ``cellpose_torch_flow_factory``'s flow_fn sees them:
    DAPI/255 over the (0, 0.65) window, resized by the model's rescale
    (linear; the labels nearest). The target is ``masks_to_flows``: unit
    flows to each disc's centre (MSE) and its foreground (BCE on the
    cellprob logit). Returns the first and last losses."""
    import cv2

    from mipheivit_tpu_torch.preprocessings.nuclei_segmentation.flow_dynamics import (
        masks_to_flows)

    dev = next(model.parameters()).device
    side = int(np.ceil(tile / model.rescale)) + 1
    size = (int(round(side * model.rescale)),) * 2
    xs, dps, fgs = [], [], []
    for _ in range(n_tiles):
        img, lab = blob_slide(rng, side, int(round(NUCLEI_DENSITY * side * side)), (10,),
                              (200,), labels=True)
        x = cv2.resize(img[0].astype(np.float32) / 255.0 / 0.65, size,
                       interpolation=cv2.INTER_LINEAR)[:tile, :tile]
        lab = cv2.resize(lab, size, interpolation=cv2.INTER_NEAREST)[:tile, :tile]
        dp, _ = masks_to_flows(lab)
        xs.append(np.stack([x, np.zeros_like(x)]))
        dps.append(dp)
        fgs.append((lab > 0).astype(np.float32))
    xs, dps, fgs = (torch.from_numpy(np.stack(a)).to(dev) for a in (xs, dps, fgs))
    opt = torch.optim.Adam(model.parameters(), lr=NUCLEI_FIT_LR)
    model.train()
    losses = []
    for step in range(steps):
        idx = torch.from_numpy(rng.choice(n_tiles, batch, replace=False)).to(dev)
        y, _ = model(xs[idx].contiguous(memory_format=torch.channels_last))
        loss = (torch.nn.functional.mse_loss(y[:, :2], dps[idx])
                + torch.nn.functional.binary_cross_entropy_with_logits(y[:, 2], fgs[idx]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if step in (0, steps - 1):
            losses.append(float(loss.detach()))
    model.eval()
    return losses


def nuclei_wsi_phase(tmp: Path, state: dict, dev):
    """[nuclei wsi]: wsi_nuclei_inference --backend torch --flow_averaging
    on a 2048^2 blob-DAPI TIFF at tile 1024, halo 128, native mpp, writing
    the labels pyramid TIFF; wall seconds split into the card's flow pass
    and the host's compute_masks. The full-width CPnet is first fitted on
    the card to blob tiles (``fit_cpnet_to_blobs``), so that its flows lead
    to the discs' centres as a trained nuclei model's do: the nuclei found
    are held against the discs painted, and the foreground against theirs."""
    from scipy import ndimage

    from mipheivit_tpu_torch.models.cellpose_net import build_cpnet
    from mipheivit_tpu_torch.preprocessings.nuclei_segmentation import flow_wsi as fw
    from mipheivit_tpu_torch.preprocessings.nuclei_segmentation import wsi_nuclei_inference as wni
    from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid

    root = tmp / "nuclei"
    root.mkdir()
    rng = np.random.default_rng(SEED + 210)
    dapi = blob_slide(rng, NUCLEI_SLIDE, NUCLEI_BLOBS, (10,), (200,))
    slide = root / "dapi.tiff"
    write_pyramid(str(slide), dapi, n_levels=2, tile_size=512, mpp=0.325)
    blobs = dapi[0] > 100
    blob_parts = int(ndimage.label(blobs)[1])
    # the CLI writes its labels expanded by --expansion_px (3 px by default)
    blob_fg = float((ndimage.distance_transform_edt(~blobs) <= 3.0).mean())
    model = build_cpnet(state, device=dev)
    t0 = time.perf_counter()
    losses = fit_cpnet_to_blobs(model, np.random.default_rng(SEED + 211), NUCLEI_FIT_STEPS,
                                NUCLEI_FIT_BATCH, NUCLEI_FIT_TILES)
    fit_s = time.perf_counter() - t0
    ckpt = root / "cp_nuclei.pth"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    del model
    stats = {}
    real = fw.cellpose_torch_flow_factory
    fw.cellpose_torch_flow_factory = lambda *a, **k: real(*a, stats=stats, **k)
    out = root / "nuclei.ome.tiff"
    try:
        reset_counts()
        t0 = time.perf_counter()
        n = wni.main(["--slide_path", str(slide), "--out_path", str(out), "--backend", "torch",
                      "--cellpose_ckpt", str(ckpt), "--flow_averaging", "--tile_size",
                      str(NUCLEI_TILE), "--halo", str(NUCLEI_HALO), "--target_mpp", "0"])
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        fw.cellpose_torch_flow_factory = real
    res = TiffSlide(str(out))
    labels = res.read_region((0, 0), 0, res.dimensions)
    dims, n_levels = res.dimensions, res.n_levels
    res.close()
    ids = np.unique(labels[..., 0])
    fg = float((labels[..., 0] > 0).mean())
    print(f"[nuclei wsi] CPnet fitted to blob tiles on the card: {NUCLEI_FIT_STEPS} steps of "
          f"{NUCLEI_FIT_BATCH} x 224^2 in {fit_s:.2f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    print(f"[nuclei wsi] wsi_nuclei_inference --backend torch --flow_averaging on a "
          f"{NUCLEI_SLIDE}^2 DAPI TIFF, tile {NUCLEI_TILE}, halo {NUCLEI_HALO}: {n} nuclei "
          f"({NUCLEI_BLOBS} discs painted, {blob_parts} connected) in {wall:.2f} s wall; flow "
          f"pass {stats['flow_s']:.2f} s ({stats['flow_s'] / wall:.3f} of the wall; CPnet "
          f"{stats['net_s']:.2f} s on {stats['tiles']} tiles of 224), compute_masks "
          f"{stats['masks_s']:.2f} s ({stats['masks_s'] / wall:.3f}) in {stats['masks']} chunks; "
          f"labels pyramid {dims} x {n_levels} levels, foreground {fg:.3f} (the discs grown "
          f"by the CLI's 3-px expansion {blob_fg:.3f}); {counts_line(counts)}", flush=True)
    check(n > 0 and dims == (NUCLEI_SLIDE, NUCLEI_SLIDE) and labels.shape[-1] == 2,
          "[nuclei wsi] no nuclei or a wrong pyramid")
    check(len(ids) == n + 1 and ids[-1] == n, "[nuclei wsi] labels are not 0..n")
    check(0.8 * blob_parts <= n <= 1.2 * NUCLEI_BLOBS and abs(fg - blob_fg) <= 0.25 * blob_fg,
          "[nuclei wsi] the nuclei found do not match the discs painted")
    check_counts("[nuclei wsi]", counts)
    return counts


def he_nuclei_phase(tmp: Path, dev):
    """[he nuclei]: he_nuclei_inference on a 2048^2 H&E TIFF (the
    haematoxylin channel through rgb2hed on the card), against the same
    script with --device cpu."""
    from mipheivit_tpu_torch.preprocessings.nuclei_segmentation import he_nuclei_inference as hni
    from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid

    root = tmp / "he_nuclei"
    root.mkdir()
    he = blob_slide(np.random.default_rng(SEED + 220), HE_SLIDE, 3000, (235, 225, 232),
                    (60, 50, 130))
    slide = root / "he.tiff"
    write_pyramid(str(slide), he, n_levels=2, tile_size=512, mpp=0.5)
    planes, walls, counts = {}, {}, None
    for device in (str(dev), "cpu"):
        out = root / f"{device.replace(':', '')}.ome.tiff"
        reset_counts()
        t0 = time.perf_counter()
        n = hni.main(["--slide_path", str(slide), "--out_path", str(out), "--tile_size", "1024",
                      "--halo", "64", "--device", device])
        walls[device] = time.perf_counter() - t0
        if device == str(dev):
            counts = read_counts()
        res = TiffSlide(str(out))
        planes[device] = (res.read_region((0, 0), 0, res.dimensions), n)
        res.close()
    (card, n), (cpu, n_cpu) = planes[str(dev)], planes["cpu"]
    same = bool(np.array_equal(card, cpu))
    print(f"[he nuclei] he_nuclei_inference on a {HE_SLIDE}^2 H&E TIFF, tile 1024: {n} nuclei in "
          f"{walls[str(dev)]:.2f} s (rgb2hed on the card) vs {n_cpu} in {walls['cpu']:.2f} s on "
          f"the CPU; pyramids equal {same}; {counts_line(counts)}", flush=True)
    check(n > 0 and same, "[he nuclei] the card's segmentation differs from the CPU's")
    check_counts("[he nuclei]", counts)
    return counts


def pix2pix_state(seed: int, ngf: int = 64, n_blocks: int = 9) -> dict:
    """A pix2pix ResnetGenerator state dict (``model.N`` keys) from a numpy
    seed: weights N(0, 0.02) (pix2pix's init), biases 0."""
    g = np.random.default_rng(seed)
    shapes = {1: (ngf, 3, 7, 7), 4: (2 * ngf, ngf, 3, 3), 7: (4 * ngf, 2 * ngf, 3, 3)}
    for i in range(n_blocks):
        for j in (1, 5):
            shapes[f"{10 + i}.conv_block.{j}"] = (4 * ngf, 4 * ngf, 3, 3)
    up0 = 10 + n_blocks
    shapes.update({up0: (4 * ngf, 2 * ngf, 3, 3), up0 + 3: (2 * ngf, ngf, 3, 3),
                   up0 + 7: (3, ngf, 7, 7)})
    out = {}
    for key, shape in shapes.items():
        out[f"model.{key}.weight"] = torch.from_numpy(
            (0.02 * g.standard_normal(shape)).astype(np.float32))
        out[f"model.{key}.bias"] = torch.zeros(shape[1] if key in (up0, up0 + 3) else shape[0])
    return out


def cycle_gan_phase(tmp: Path, dev):
    """[cycle gan]: the stain normaliser ResnetGenerator(64, 9) from a pix2pix
    checkpoint on a batch of 4 tiles of 512^2 in f32, held against the CPU
    on 1 tile; then cycle_gan_wsi_inference on a 1536 x 1024 H&E TIFF."""
    from mipheivit_tpu_torch.infer.loading import load_state_dict
    from mipheivit_tpu_torch.preprocessings.cycle_gan import cycle_gan_wsi_inference as cgw
    from mipheivit_tpu_torch.preprocessings.cycle_gan.resnet_generator import (
        build_generator, params_from_torch)
    from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid

    root = tmp / "cycle_gan"
    root.mkdir()
    ckpt = root / "latest_net_G.pth"
    torch.save(pix2pix_state(SEED + 230), ckpt)
    state = params_from_torch(load_state_dict(str(ckpt)))
    model = build_generator(state, device=dev)
    g = np.random.default_rng(SEED + 231)
    w, h = CYCLE_SLIDE
    he = g.integers(0, 256, (3, h, w), dtype=np.uint8)
    # the slide script's first batch: its tiles in raster order
    coords = [(x0, y0) for y0 in range(0, h, CYCLE_IMG) for x0 in range(0, w, CYCLE_IMG)]
    tiles = np.stack([he[:, y0:y0 + CYCLE_IMG, x0:x0 + CYCLE_IMG].transpose(1, 2, 0)
                      for x0, y0 in coords[:CYCLE_BATCH]])
    x = torch.from_numpy(tiles).to(dev).float() / 127.5 - 1.0
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        pred = model(x)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.inference_mode():
        cpu = build_generator(state, device="cpu")(x[:1].cpu())
    diff = float((pred[:1].cpu() - cpu).abs().max())
    slide, out = root / "he.tiff", root / "he_normalized.tiff"
    write_pyramid(str(slide), he, n_levels=2, tile_size=512, mpp=0.5)
    t0 = time.perf_counter()
    cgw.main(["--slide_path", str(slide), "--checkpoint", str(ckpt), "--out_path", str(out),
              "--tile_size", str(CYCLE_IMG), "--batch_size", str(CYCLE_BATCH)])
    wsi_s = time.perf_counter() - t0
    counts = read_counts()
    res = TiffSlide(str(out))
    norm = res.read_region((0, 0), 0, res.dimensions)
    dims, n_levels = res.dimensions, res.n_levels
    res.close()
    steps = int(np.abs(norm[:CYCLE_IMG, :CYCLE_IMG].astype(int)
                       - cgw.to_uint8(pred[0].cpu().numpy()).astype(int)).max())
    print(f"[cycle gan] ResnetGenerator(64, 9) f32, batch {CYCLE_BATCH} x {CYCLE_IMG}^2: "
          f"{ms:.2f} ms/batch ({CYCLE_BATCH * 1000 / ms:.1f} tiles/s, CUDA events, median of "
          f"10), peak {peak:.2f} GiB; card vs CPU on 1 tile: max_abs_diff {diff:.3e} (tol "
          f"{CYCLE_TOL:g}); cycle_gan_wsi_inference {w} x {h} TIFF in {wsi_s:.2f} s -> {dims} x "
          f"{n_levels} levels, tile (0, 0) within {steps} uint8 step(s) of the batch's; "
          f"{counts_line(counts)}", flush=True)
    check(bool(torch.isfinite(pred).all()) and diff <= CYCLE_TOL,
          "[cycle gan] the card's generator differs from the CPU's")
    check(dims == (w, h) and n_levels == 4 and steps <= 1 and norm.std() > 0,
          "[cycle gan] the normalised slide")
    check_counts("[cycle gan]", counts)
    return counts


def trainer_profile_phase(tmp: Path, ckpt: Path, enc: Path, data_values: dict, depth: int):
    """[trainer profile]: train_patchgan(profile_steps=2) on the [trainer]
    configuration for 1 epoch of TRAINER_STEPS microbatches: the trace's
    path, size and five longest device ops. The run's snapshot and export
    are not written ([trainer] writes them; the machine caps a run's disk
    writes at 45 GiB)."""
    import gzip

    import mipheivit_tpu_torch.train.trainer as trainer

    cfg = trainer_config(trainer_overrides(data_values, ckpt, enc, 1))
    logdir = tmp / "trainer_profile"
    real = {name: getattr(trainer, name) for name in ("save_train_state", "save_generator")}
    for name in real:
        setattr(trainer, name, lambda *a, **k: None)
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = trainer.train_patchgan(cfg, str(logdir), max_steps_per_epoch=TRAINER_STEPS,
                                     use_wandb=False, profile_steps=PROFILE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        for name, fn in real.items():
            setattr(trainer, name, fn)
    path = Path(out.get("profile", ""))
    check(path.is_file() and path.parent == logdir / "profile", "[trainer profile] no trace")
    events = json.loads(gzip.decompress(path.read_bytes()))["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: -float(e.get("dur", 0)))
    top = "; ".join(f"{e['name'][:70]} {float(e['dur']):.0f} us" for e in kernels[:5])
    busy = sum(float(e.get("dur", 0)) for e in kernels) / 1e3
    print(f"[trainer profile] train_patchgan(profile_steps={PROFILE_STEPS}), flagship preset, "
          f"{depth} blocks, 1 epoch of {TRAINER_STEPS} microbatches in {wall:.1f} s: trace "
          f"{path.relative_to(tmp)} {path.stat().st_size / 2 ** 20:.2f} MiB, {len(kernels)} "
          f"kernels, {busy:.1f} ms of kernel time; five longest: {top}; {counts_line(counts)}",
          flush=True)
    check(len(kernels) > 0, "[trainer profile] the trace holds no device kernel")
    n_fwd = TRAINER_STEPS + 1 + TRAINER_TILES["val"] // 8 + TRAINER_TILES["test"] // 8
    check_counts("[trainer profile]", counts, k1=depth * n_fwd, k2=depth * n_fwd,
                 k2b=depth * TRAINER_STEPS)
    path.unlink()
    return counts


def tiff_phase(tmp: Path):
    """[tiff]: pyramids at write_pyramid's dtypes written and read back bit
    for bit by the native engine (slidetiff.cpp, built here against the
    libtiff it names), level 0 also as Pillow decodes each channel's page."""
    from PIL import Image

    from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid
    from mipheivit_tpu_torch.slideio.native.build import find_libtiff

    t0 = time.perf_counter()
    g = np.random.default_rng(SEED + 240)
    cases = {"uint8 x 3": g.integers(0, 256, (3, 1000, 1300), dtype=np.uint8),
             "uint16": g.integers(0, 65536, (1, 1000, 1300), dtype=np.uint16),
             "int32 x 2": g.integers(0, 2 ** 31 - 1, (2, 1000, 1300), dtype=np.int32),
             "float32": g.standard_normal((1, 1000, 1300)).astype(np.float32)}
    ok = True
    for name, data in cases.items():
        path = tmp / f"tiff_{name.split()[0]}.tiff"
        write_pyramid(str(path), data, n_levels=3, tile_size=512, mpp=0.5)
        slide = TiffSlide(str(path))
        levels = [slide.read_region((0, 0), lvl, slide.level_dimensions[lvl])
                  for lvl in range(slide.n_levels)]
        slide.close()
        ok = ok and len(levels) == 3 and np.array_equal(levels[0], data.transpose(1, 2, 0))
        with Image.open(path) as im:
            for ch in range(len(data)):
                im.seek(ch)
                ok = ok and np.array_equal(np.asarray(im).astype(data.dtype), data[ch])
        path.unlink()
    print(f"[tiff] native engine on {find_libtiff()}; {', '.join(cases)} 1300 x 1000, 3 levels: "
          f"read back bit for bit, level 0 also through Pillow: {ok} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(ok, "[tiff] a pyramid did not read back bit for bit")


def preprocessing_phases(tmp: Path, ckpt: Path, enc: Path, data_values: dict, depth: int, dev):
    """The preprocessing phases, in order; returns each path's launch
    counts."""
    tiff_phase(tmp)
    counts = {}
    counts["cellpose"], state = cellpose_phase(dev)
    torch.cuda.empty_cache()
    counts["nuclei wsi"] = nuclei_wsi_phase(tmp, state, dev)
    counts["he nuclei"] = he_nuclei_phase(tmp, dev)
    counts["cycle gan"] = cycle_gan_phase(tmp, dev)
    torch.cuda.empty_cache()
    counts["trainer profile"] = trainer_profile_phase(tmp, ckpt, enc, data_values, depth)
    return counts


def pearson(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-marker Pearson correlation of two ``[..., C]`` arrays."""
    a = a.reshape(-1, a.shape[-1]).astype(np.float64)
    b = b.reshape(-1, b.shape[-1]).astype(np.float64)
    a, b = a - a.mean(0), b - b.mean(0)
    return (a * b).sum(0) / np.sqrt((a * a).sum(0) * (b * b).sum(0))


# ---- multi-card paths: ranks spawned on the one card ----------------------

# two ranks share the one card (gloo: NCCL refuses a duplicate GPU); each
# phase drives the path a user of several cards runs, one process a card
PAR_RANKS = 2
SEQ_WSI_BATCH = 1                # [seq shard wsi 1024]: one window a forward
SEQ_REGION = 2048                # [seq shard 2048]: 146 x 146 + 5 = 21 321 tokens
SEQ_TOKENS = (SEQ_REGION // 14) ** 2 + 5
SEQ_PEARSON = 0.999              # sharded against unsharded forward, bf16, per marker
SEQ_LORA_COS = 0.999             # [train seq shard 1024] against the one-rank step
# the reduced gradient's norm over the one-process step's, LoRA and decoder
# apart: a gradient scaled by the shard count is off by 2x here (Adam hides
# such a scale from the losses); the rest is room for bf16 rounding
GRAD_NORM_TOL = 1e-2
DDP_BATCH = MICRO // PAR_RANKS   # [trainer ddp]: 4 a rank, [trainer]'s global 8
DDP_LOSS_RTOL = 1e-4             # its epoch's mean loss against [trainer]'s (bf16)
COLLECTIVE_REPS = 5
# tensor parallelism over the ranks (shard_params): [tp forward] at one batch
# of 16 tiles (K1 at 12 heads a rank) and one 1024-px region (K4 at 12
# heads); each rank's output against the unsharded forward of the same
# weights per marker, and f32 at 2 blocks against the CPU's plain chain,
# scaled to max |ref|; [tp train 256] against the one-rank step: the bf16
# first loss, and the first microbatch's LoRA q/v gradients in bf16 and in
# f32. In bf16 at 40 blocks of these random weights any change of rounding
# moves those gradients by about bf16's own noise (the bf16 step against
# the f32 one: cosine 0.9947 in [numerics train] on an H100), and the sharded products
# (other GEMM shapes, partial sums) round otherwise, so bf16 is held at the
# bar of that comparison; f32 shows the sharded gradient itself
TP_TILES = 16
TP_PEARSON = 0.999
TP_F32_TOL = 2e-3
TP_LOSS_RTOL = 1e-3
TP_BF16_LORA_COS = BF16_LORA_COS
TP_F32_LOSS_RTOL = 1e-5
TP_F32_LORA_COS = 0.9999
# [tp train 1024]'s f32 microbatch: the encoder's first blocks, as
# [numerics train]'s f32 region step
TP_REGION_F32_DEPTH = 2
TP_REPS = 3
TP_SWIN_MICRO = CTRANSPATH_PRESET["train"]["batch_size"]     # [tp swin]'s microbatch


def _sync_ms(fn, group, reps=COLLECTIVE_REPS):
    """Median wall ms of ``fn()`` on every rank at once (a barrier before
    each call, the card synchronized around it), after one warm-up call."""
    import torch.distributed as dist

    fn()
    times = []
    for _ in range(reps):
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def collectives_rank(dev):
    """[collectives]: the three collectives of the port, on CUDA tensors at
    the k | v size of a 1024-px block: all_gather_into_tensor of each
    rank's [1, 2667, 3072] bf16 shard (16.4 MB in, 32.8 MB out),
    reduce_scatter_tensor of [1, 5334, 3072] (32.8 MB in) and all_reduce of
    it, each through the port's helpers."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.parallel import make_mesh
    from mipheivit_tpu_torch.parallel.seq import _all_gather_tokens, _reduce_scatter_tokens

    group = make_mesh(1, PAR_RANKS).model_group
    g = torch.Generator(device=dev).manual_seed(SEED + 80 + dist.get_rank())
    rows = -(-REGION_S // PAR_RANKS)
    whole = torch.randn(1, rows * PAR_RANKS, 2 * HD, device=dev, generator=g).to(torch.bfloat16)
    half = whole[:, :rows].contiguous()
    gathered = _all_gather_tokens(half, group)
    ok = gathered.shape == whole.shape and torch.equal(
        gathered[:, dist.get_rank() * half.shape[1]:][:, :half.shape[1]], half)
    return {"backend": dist.get_backend(group), "gather_ok": bool(ok),
            "all_gather_ms": _sync_ms(lambda: _all_gather_tokens(half, group), group),
            "reduce_scatter_ms": _sync_ms(lambda: _reduce_scatter_tokens(whole, group), group),
            "all_reduce_ms": _sync_ms(lambda: dist.all_reduce(whole, group=group), group),
            "bytes": whole.numel() * whole.element_size()}


def nccl_probe(dev):
    """Whether NCCL carries a collective between the ranks on this one card
    (it is expected to refuse a duplicate GPU); the error's first line."""
    import torch.distributed as dist

    group = dist.new_group(list(range(PAR_RANKS)), backend="nccl")
    try:
        dist.all_reduce(torch.ones(1, device=dev), group=group)
        torch.cuda.synchronize()
        return "carried"
    except Exception as e:              # the refusal is the expected answer
        text = str(e)
        match = re.search(r"Duplicate GPU detected[^\n]*", text)
        return "refused: " + (match.group(0) if match else text.splitlines()[0])[:160]


def seq_wsi_rank(ckpt, enc, ref_path, dev):
    """[seq shard wsi 1024]: wsi_inference over the 2048^2 slide in 1024-px
    windows with each window's tokens sharded over the ranks (rank 0
    stitches); then, on rank 0, K4's query shard rectangle (2667 x 5334)
    beside the square call (5334 x 5334)."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE
    from mipheivit_tpu_torch.models.vit import set_attn_impl
    from mipheivit_tpu_torch.ops import attention as attn
    from mipheivit_tpu_torch.parallel import make_mesh

    rank = dist.get_rank()
    mesh = make_mesh(1, PAR_RANKS)
    model = set_attn_impl(load(ckpt, enc, dev, torch.bfloat16, REGION), "seq_shard")
    slide = np.random.default_rng(SEED + 2).integers(0, 256, (SLIDE, SLIDE, 3), dtype=np.uint8)
    out = np.zeros((MARKERS, SLIDE, SLIDE), np.uint8) if rank == 0 else None
    stats = {}
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    wsi_inference(model, ArraySlide(slide), out, [f"m{i}" for i in range(MARKERS)], HOPTIMUS_HE,
                  tile_size=REGION, overlap=128, batch_size=SEQ_WSI_BATCH, tissue_only=False,
                  stats=stats, seq_shard_mesh=mesh)
    torch.cuda.synchronize()
    res = {"counts": read_counts(), "wall_s": time.perf_counter() - t0,
           "windows": stats["n_tiles"]}
    res["int8"] = seq_wsi_int8(model, slide, mesh, dev)
    del model
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        ref = np.load(ref_path)
        res["diff"] = int(np.abs(out.astype(np.int16) - ref.astype(np.int16)).max())
        t = torch.from_numpy(np.random.default_rng(SEED + 81).standard_normal(
            (1, REGION_S, 3 * HD), dtype=np.float32)).to(dev, torch.bfloat16)
        q, k, v = t[..., :HD], t[..., HD:2 * HD], t[..., 2 * HD:]
        rows = -(-REGION_S // PAR_RANKS)
        with torch.inference_mode():
            res["rect_ms"] = cuda_ms(lambda: attn.flash_attention(q[:, :rows], k, v, HEADS,
                                                                  REGION_S))
            res["square_ms"] = cuda_ms(lambda: attn.flash_attention(q, k, v, HEADS))
        res["rect_bound"] = bound_ms(2 * (2 * rows + 2 * REGION_S) * HD,
                                     4.0 * HEADS * rows * REGION_S * 64, "bf16")
    dist.barrier()
    return res


def seq_wsi_int8(model, slide, mesh, dev):
    """[seq shard int8]: the sharded float generator of [seq shard wsi 1024]
    quantised (quantize_encoder -> quantize_decoder) and driven through
    wsi_inference(seq_shard_mesh) over the top-left INT8_SEQ_SLIDE^2 of the
    slide with the launch counts at 0; the serial stitch, sharded too, of
    the float generator before and of the int8 one after; on rank 0 the
    per-marker Pearson of the int8 serial stitch against the float one
    before the uint8 cast, of the int8 pipeline's slide against the float
    serial stitch cast after it, and the pipeline against its serial
    stitch; then, on rank 0 with its attention unsharded, the same int8
    generator's serial stitch: the sharded int8 serial stitch against it
    (per-marker Pearson before the uint8 cast) and the pipeline's slide
    against it cast (max uint8 step)."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.infer import (ArraySlide, quantize_decoder, quantize_encoder,
                                           wsi_inference)
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE
    from mipheivit_tpu_torch.models.vit import set_attn_impl
    from mipheivit_tpu_torch.parallel import seq_shard_scope

    image = np.ascontiguousarray(slide[:INT8_SEQ_SLIDE, :INT8_SEQ_SLIDE])

    def serial():
        with seq_shard_scope(mesh):
            return serial_stitch(model, image, REGION, 128, SEQ_WSI_BATCH, dev, np.float32)

    float_f32 = serial()
    quantize_decoder(quantize_encoder(model))
    out = np.zeros_like(float_f32, np.uint8) if dist.get_rank() == 0 else None
    stats = {}
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    wsi_inference(model, ArraySlide(image), out, [f"m{i}" for i in range(MARKERS)], HOPTIMUS_HE,
                  tile_size=REGION, overlap=128, batch_size=SEQ_WSI_BATCH, tissue_only=False,
                  stats=stats, seq_shard_mesh=mesh)
    torch.cuda.synchronize()
    res = {"counts": read_counts(), "wall_s": time.perf_counter() - t0,
           "windows": stats["n_tiles"]}
    int8_f32 = serial()
    if out is not None:
        res["pearson"] = pearson(np.moveaxis(int8_f32, 0, -1), np.moveaxis(float_f32, 0, -1))
        res["pearson_uint8"] = pearson(np.moveaxis(out, 0, -1),
                                       np.moveaxis(float_f32.astype(np.uint8), 0, -1))
        res["serial_diff"] = int(np.abs(out.astype(np.int16)
                                        - int8_f32.astype(np.uint8).astype(np.int16)).max())
        set_attn_impl(model, "auto")
        solo = serial_stitch(model, image, REGION, 128, SEQ_WSI_BATCH, dev, np.float32)
        set_attn_impl(model, "seq_shard")
        res["solo_pearson"] = pearson(np.moveaxis(int8_f32, 0, -1), np.moveaxis(solo, 0, -1))
        res["solo_diff"] = int(np.abs(out.astype(np.int16)
                                      - solo.astype(np.uint8).astype(np.int16)).max())
    dist.barrier()
    return res


def seq_2048_rank(ckpt, enc, dev):
    """[seq shard 2048]: one 2048-px region (21 321 tokens) through the
    generator with its tokens sharded over the ranks, each rank's peak
    memory; then on rank 0 the unsharded forward and the per-marker
    Pearson of the two."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE
    from mipheivit_tpu_torch.models.vit import set_attn_impl
    from mipheivit_tpu_torch.parallel import make_mesh, seq_shard_scope

    rank = dist.get_rank()
    mesh = make_mesh(1, PAR_RANKS)
    model = set_attn_impl(load(ckpt, enc, dev, torch.bfloat16, SEQ_REGION), "seq_shard")
    slide = np.random.default_rng(SEED + 2).integers(0, 256, (SLIDE, SLIDE, 3), dtype=np.uint8)
    mean = torch.as_tensor(HOPTIMUS_HE.mean, device=dev)
    std = torch.as_tensor(HOPTIMUS_HE.std, device=dev)
    x = (torch.from_numpy(slide[None, :SEQ_REGION, :SEQ_REGION]).to(dev).float() - mean) / std
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode(), seq_shard_scope(mesh):
        y = model(x)
    torch.cuda.synchronize()
    res = {"counts": read_counts(), "s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "finite": bool(torch.isfinite(y).all()), "tokens": model.vit_cfg.num_patches + 5}
    y = y.float().cpu().numpy()
    dist.barrier()
    if rank == 0:
        set_attn_impl(model, "auto")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            y0 = model(x).float().cpu().numpy()
        torch.cuda.synchronize()
        res.update(solo_s=time.perf_counter() - t0,
                   solo_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   pearson=pearson(y, y0))
    del model
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def train_seq_rank(ckpt, enc, dev):
    """[train seq shard 1024]: the flagship's generator step at 1024 px
    (microbatch 1, accumulation 2, 2 optimizer steps on [train 1024]'s
    regions) with the encoder's tokens sharded over the ranks; the
    trainable weights' digest after the 2 updates; on rank 0, the first
    microbatch's reduced gradients against the one-rank step's: the LoRA
    q/v cosine, and the LoRA and decoder norms' ratios."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.models.vit import set_attn_impl
    from mipheivit_tpu_torch.parallel import make_mesh, seq_shard_scope
    from mipheivit_tpu_torch.parallel.workers import digest

    rank = dist.get_rank()
    mesh = make_mesh(1, PAR_RANKS)
    model = set_attn_impl(train_model(ckpt, enc, REGION, dev), "seq_shard")
    data = train_batches(2 * ACCUM, REGION_MICRO, REGION, dev, SEED + 4)
    state, step = train_setup(model, dev, torch.bfloat16, mesh=mesh)
    metrics = PixelMetrics.zeros(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    losses, step_s = [], []
    with seq_shard_scope(mesh):
        for s in range(2):
            t0 = time.perf_counter()
            for a in range(ACCUM):
                state, metrics, log = step(state, data[s * ACCUM + a], metrics)
                losses.append(float(log["gen_loss"]))
                if s == a == 0:
                    grads0 = {n: g.detach().float().cpu() for n, g in log["grads"].items()}
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    res = {"counts": read_counts(), "losses": losses, "step_s": step_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "digest": digest({n: p for n, p in state.gen_params})}
    del state, step, model, log
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        ref = one_step_grads(train_model(ckpt, enc, REGION, dev), data[0], dev, torch.bfloat16)
        res["cos"] = lora_cos((losses[0], grads0), ref)
        res["norm_ratio"] = norm_ratio(grad_norms(grads0), grad_norms(ref[1]))
        res["solo_loss"] = ref[0]
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def trainer_ddp_rank(tmp, ckpt, enc, data_values):
    """[trainer ddp]: train_patchgan on the flagship preset over the ranks,
    4 rows a rank (the global batch of [trainer]), 1 epoch of
    TRAINER_STEPS microbatches on [trainer]'s tiles; every rank but 0
    raises on a write. The preset's own monitor, val_cell_auc, is absent
    without a slide dataframe, so no best export is written: the smoke's
    disk writes stay near the card machine's limit without the ~4.6 GB of
    a snapshot and an export (the CPU tests hold the ranks' snapshots and
    exports). The steady images/s from CUDA events behind the steps, as
    [trainer] takes them."""
    import torch.distributed as dist

    import mipheivit_tpu_torch.train.trainer as trainer
    from mipheivit_tpu_torch.parallel.workers import digest

    rank = dist.get_rank()
    cfg = trainer_config(trainer_overrides(data_values, Path(ckpt), Path(enc), 1))
    cfg.set_dotted("train.batch_size", DDP_BATCH)
    for key in ("monitor", "mode"):
        cfg.set_dotted(f"train.callbacks.modelcheckpoint.{key}",
                       FLAGSHIP_PRESET["train"]["callbacks"]["modelcheckpoint"][key])
    logdir = Path(tmp) / "trainer_ddp_run"
    rec, undo = instrument_trainer(trainer, norms=True)
    writers = ("MetricsLogger", "save_config", "save_train_state", "save_generator")
    real = {name: getattr(trainer, name) for name in writers}
    if rank != 0:
        def refuse(*a, **kw):
            raise AssertionError(f"rank {rank} tried to write")

        for name in writers:
            setattr(trainer, name, refuse)
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = trainer.train_patchgan(cfg, str(logdir), max_steps_per_epoch=TRAINER_STEPS,
                                     use_wandb=False)
    finally:
        for name, fn in real.items():
            setattr(trainer, name, fn)
        undo()
    torch.cuda.synchronize()
    ev = rec["events"][-1]
    res = {"counts": read_counts(), "s": time.perf_counter() - t0, "step": out["state"].step,
           "digest": digest(out["state"].generator.state_dict()),
           "loss": out["history"][0]["gen_loss"],
           "val": out["history"][0]["val_gen_loss_sim"],
           # steps 3-4: one optimizer step of the global batch
           "rate": 2 * DDP_BATCH * PAR_RANKS * 1000.0 / ev[1].elapsed_time(ev[3]),
           "grad_norms": rec["grad_norms"][-1]}
    dist.barrier()
    if rank == 0:
        res["metric_lines"] = len((logdir / "metrics.jsonl").read_text().splitlines())
        res["status"] = (logdir / "status.txt").read_text()
        res["files"] = sorted(p.name for p in logdir.iterdir())
    return res


def tp_inputs(dev):
    """The tensor-parallel forwards' inputs, normalised on the card: a batch
    of TP_TILES uint8 tiles of IMG px and one REGION-px region."""
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE

    mean = torch.as_tensor(HOPTIMUS_HE.mean, device=dev)
    std = torch.as_tensor(HOPTIMUS_HE.std, device=dev)
    tiles = np.random.default_rng(SEED + 1).integers(0, 256, (TP_TILES, IMG, IMG, 3),
                                                     dtype=np.uint8)
    slide = np.random.default_rng(SEED + 2).integers(0, 256, (REGION, REGION, 3), dtype=np.uint8)
    return ((torch.from_numpy(tiles).to(dev).float() - mean) / std,
            (torch.from_numpy(slide[None]).to(dev).float() - mean) / std)


@contextlib.contextmanager
def all_reduce_tally():
    """Count ``torch.distributed.all_reduce`` calls and their bytes by dtype
    while inside (the port's collectives call it through the module):
    ``{dtype: [calls, bytes]}``."""
    import torch.distributed as dist

    tally = {}
    real = dist.all_reduce

    def counted(t, *args, **kw):
        row = tally.setdefault(str(t.dtype).replace("torch.", ""), [0, 0])
        row[0] += 1
        row[1] += t.numel() * t.element_size()
        return real(t, *args, **kw)

    dist.all_reduce = counted
    try:
        yield tally
    finally:
        dist.all_reduce = real


def tally_text(tally: dict) -> str:
    return ", ".join(f"{n} of {dt} ({b / 1e6:.1f} MB)" for dt, (n, b) in sorted(tally.items()))


def tp_forward_rank(ckpt, enc, dev):
    """[tp forward]: the serving generator (load_generator(fast_heads) ->
    merge_lora -> cast_params(bf16)) at 256 and at 1024 px, each rank's
    output of the unsharded forward first, then shard_params over the
    ranks and, with the launch counts at 0, one batch of TP_TILES tiles and
    one 1024-px region; then each forward's wall ms and the all-reduce of
    one block's output, timed; the f32 generator cut to 2 blocks sharded on
    one tile, and on rank 0 the same unsharded on the CPU (plain
    versions)."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.parallel import make_mesh, shard_params

    rank = dist.get_rank()
    mesh = make_mesh(1, PAR_RANKS)
    group = mesh.model_group
    x, xr = tp_inputs(dev)
    models = {"tiles": (load(ckpt, enc, dev, torch.bfloat16, IMG), x),
              "region": (load(ckpt, enc, dev, torch.bfloat16, REGION), xr)}
    with torch.inference_mode():
        want = {k: m(v).float().cpu().numpy() for k, (m, v) in models.items()}
    for m, _ in models.values():
        shard_params(m, mesh)
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = {k: m(v) for k, (m, v) in models.items()}
    torch.cuda.synchronize()
    res = {"counts": read_counts(), "s": time.perf_counter() - t0,
           "finite": all(bool(torch.isfinite(g).all()) for g in got.values()),
           "pearson": {k: pearson(g.float().cpu().numpy(), want[k]) for k, g in got.items()}}
    with torch.inference_mode():
        for k, (m, v) in models.items():
            res[f"{k}_ms"] = _sync_ms(lambda: m(v), group, reps=TP_REPS)
            # one block's output: what each row-split proj and fc2 all-reduces
            block = torch.zeros(v.shape[0], 329 if k == "tiles" else REGION_S, HD, device=dev,
                                dtype=torch.bfloat16)
            res[f"{k}_allreduce_ms"] = _sync_ms(lambda: dist.all_reduce(block, group=group),
                                                group)
            res[f"{k}_bytes"] = block.numel() * block.element_size()
    del models, got
    torch.cuda.empty_cache()
    m32 = load(ckpt, enc, dev, torch.float32, IMG)
    m32.encoder.vit.blocks = m32.encoder.vit.blocks[:2]
    shard_params(m32, mesh)
    with torch.inference_mode():
        card2 = m32(x[:1]).cpu()
    del m32
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        cpu = load(ckpt, enc, "cpu", torch.float32, IMG)
        cpu.encoder.vit.blocks = cpu.encoder.vit.blocks[:2]
        with torch.inference_mode():
            ref = cpu(x[:1].cpu())
        res["f32_rel"] = float((card2 - ref).abs().max() / ref.abs().max())
        del cpu
    dist.barrier()
    return res


def tp_train_rank(ckpt, enc, dev):
    """[tp train 256]: the flagship preset's generator step (LoRA 8 on q and
    v live, the frozen encoder stored bf16) with the encoder sharded over the
    ranks (shard_params before create_train_state), microbatch MICRO x
    accumulation ACCUM, 2 optimizer steps on [train 256]'s first
    microbatches, with the launch counts at 0; the replicated tensors'
    digest after the steps; on rank 0 the one-rank step's first microbatch:
    the loss and the LoRA q/v gradients against the sharded step's."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.parallel import make_mesh, shard_params
    from mipheivit_tpu_torch.parallel.sharding import param_layouts
    from mipheivit_tpu_torch.parallel.workers import digest

    rank = dist.get_rank()
    mesh = make_mesh(1, PAR_RANKS)
    model = shard_params(train_model(ckpt, enc, IMG, dev), mesh)
    data = train_batches(2 * ACCUM, MICRO, IMG, dev, SEED + 3)
    state, step = train_setup(model, dev, torch.bfloat16, mesh=mesh)
    metrics = PixelMetrics.zeros(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    losses, step_s = [], []
    for s in range(2):
        t0 = time.perf_counter()
        for a in range(ACCUM):
            state, metrics, log = step(state, data[s * ACCUM + a], metrics)
            losses.append(float(log["gen_loss"]))
            if s == a == 0:
                grads0 = {n: g.detach().float().cpu() for n, g in log["grads"].items()}
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    layouts = param_layouts(model)
    res = {"counts": read_counts(), "losses": losses, "step_s": step_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "digest": digest({n: t for n, t in model.state_dict().items() if n not in layouts}),
           "shards": len(layouts)}
    del state, step, model, log
    torch.cuda.empty_cache()
    # the same first microbatch in f32, sharded, where rounding moves the
    # gradients by ~1e-7 instead of bf16's ~4e-3 a product
    got32 = one_step_grads(shard_params(train_model(ckpt, enc, IMG, dev), mesh), data[0], dev,
                           mesh=mesh)
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        ref = one_step_grads(train_model(ckpt, enc, IMG, dev), data[0], dev, torch.bfloat16)
        torch.cuda.empty_cache()
        again = one_step_grads(train_model(ckpt, enc, IMG, dev), data[0], dev, torch.bfloat16)
        torch.cuda.empty_cache()
        ref32 = one_step_grads(train_model(ckpt, enc, IMG, dev), data[0], dev)
        res.update(cos=lora_cos((losses[0], grads0), ref), solo_loss=ref[0],
                   ratio=norm_ratio(grad_norms(grads0), grad_norms(ref[1])),
                   again_cos=lora_cos(again, ref), again_loss=again[0],
                   cos32=lora_cos(got32, ref32), ratio32=norm_ratio(grad_norms(got32[1]),
                                                                    grad_norms(ref32[1])),
                   loss32=(got32[0], ref32[0]))
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def tp_int8_rank(ckpt, enc, dev):
    """[tp int8 forward]: the serving generator in int8 W8A8 (load ->
    quantize_encoder) at 256 and at 1024 px, each rank's unsharded int8
    output first; then shard_params over the ranks (the int8 qkv and fc1
    cut with their scales, the row-split proj and fc2 quantised at the
    rows' amax max-reduced over the ranks, their int32 partial products
    summed) and, with the launch counts at 0, one batch of TP_TILES tiles
    and one 1024-px region, each timed with its all-reduces tallied; then
    one block's int32 sum and row-scale max alone."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.infer import quantize_encoder
    from mipheivit_tpu_torch.infer.tiles import predictions_to_uint8
    from mipheivit_tpu_torch.parallel import make_mesh, shard_params
    from mipheivit_tpu_torch.parallel.mesh import max_over_model, sum_int_over_model

    mesh = make_mesh(1, PAR_RANKS)
    group = mesh.model_group
    x, xr = tp_inputs(dev)
    models = {"tiles": (quantize_encoder(load(ckpt, enc, dev, torch.bfloat16, IMG)), x),
              "region": (quantize_encoder(load(ckpt, enc, dev, torch.bfloat16, REGION)), xr)}
    with torch.inference_mode():
        want = {k: m(v).float().cpu().numpy() for k, (m, v) in models.items()}
    for m, _ in models.values():
        shard_params(m, mesh)
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    res = {"s": {}, "tally": {}, "pearson": {}, "uint8_equal": {}, "finite": True}
    for k, (m, v) in models.items():
        dist.barrier(group=group)
        t0 = time.perf_counter()
        with torch.inference_mode(), all_reduce_tally() as tally:
            got = m(v).float().cpu().numpy()
        res["s"][k] = time.perf_counter() - t0
        res["tally"][k] = tally
        res["finite"] = res["finite"] and bool(np.isfinite(got).all())
        res["pearson"][k] = pearson(got, want[k])
        res["uint8_equal"][k] = float((predictions_to_uint8(got)
                                       == predictions_to_uint8(want[k])).mean())
    res["counts"] = read_counts()
    del models
    torch.cuda.empty_cache()
    acc = torch.zeros(TP_TILES * 329, HD, dtype=torch.int32, device=dev)
    amax = torch.zeros(TP_TILES * 329, 1, device=dev)
    res["int32_ms"] = _sync_ms(lambda: sum_int_over_model(acc, group), group)
    res["max_ms"] = _sync_ms(lambda: max_over_model(amax, group), group)
    res["int32_bytes"], res["max_bytes"] = acc.numel() * 4, amax.numel() * 4
    return res


def tp_swin_rank(dev):
    """[tp swin]: unet_lora on ctranspath (Swin-T with the conv stem and LoRA,
    heads 3/6/12/24) at full width and IMG px, seeded weights, heads through
    contrast_head: the f32 and the bf16 forward of TP_TILES tiles
    unsharded, then shard_params over the ranks (stage 0's 3 heads split 2
    + 1; the Swin MLP whole) and the same forwards, the bf16 one timed with
    its all-reduces tallied;
    then the preset's step sharded, two microbatches of TP_SWIN_MICRO tiles
    with the counts at 0: the losses, the replicated tensors' digest; on
    rank 0 the unsharded step's first loss."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.infer import cast_params
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.parallel import make_mesh, shard_params
    from mipheivit_tpu_torch.parallel.sharding import param_layouts
    from mipheivit_tpu_torch.parallel.workers import digest

    rank = dist.get_rank()
    mesh = make_mesh(1, PAR_RANKS)
    seed = SEED + 90
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (TP_TILES, IMG, IMG, 3), dtype=np.float32)).to(dev)
    want, got = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        model = cast_params(contrast_heads(fresh_generator("unet_lora", "ctranspath", dev, seed)),
                            dt).eval()
        with torch.inference_mode():
            want[dt] = model(x).float().cpu().numpy()
        shard_params(model, mesh)
        torch.cuda.synchronize()
        dist.barrier()
        if dt == torch.bfloat16:
            reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode(), all_reduce_tally() as tally:
            got[dt] = model(x).float().cpu().numpy()
        secs = time.perf_counter() - t0
    bf16, f32 = torch.bfloat16, torch.float32
    res = {"s": secs, "tally": tally, "counts": read_counts(),
           "finite": all(bool(np.isfinite(g).all()) for g in got.values()),
           "pearson": pearson(got[bf16], want[bf16]), "pearson32": pearson(got[f32], want[f32]),
           "f32_rel": float(np.abs(got[f32] - want[f32]).max() / np.abs(want[f32]).max()),
           "bf16_vs_f32": pearson(got[bf16], want[f32]), "floor": pearson(want[bf16], want[f32]),
           "heads": [blk.attn.num_heads for stage in model.encoder.model.layers
                     for blk in stage.blocks]}
    del model
    torch.cuda.empty_cache()
    data = train_batches(2, TP_SWIN_MICRO, IMG, dev, SEED + 33)
    model = shard_params(fresh_generator("unet_lora", "ctranspath", dev, seed), mesh)
    state, step = family_step(model, "unet_lora", TP_SWIN_MICRO, dev, mesh=mesh)
    metrics = PixelMetrics.zeros(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    losses, step_s = [], []
    with all_reduce_tally() as tally:
        for batch in data:
            t0 = time.perf_counter()
            state, metrics, log = step(state, batch, metrics)
            losses.append(float(log["gen_loss"]))
            step_s.append(time.perf_counter() - t0)
    layouts = param_layouts(model)
    res["train"] = {"counts": read_counts(), "losses": losses, "step_s": step_s, "tally": tally,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "digest": digest({n: t for n, t in model.state_dict().items()
                                      if n not in layouts}),
                    "shards": len(layouts), "trainable": len(state.gen_params)}
    del state, step, model, log
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        state, step = family_step(fresh_generator("unet_lora", "ctranspath", dev, seed),
                                  "unet_lora", TP_SWIN_MICRO, dev)
        _, _, log = step(state, data[0], PixelMetrics.zeros(dev))
        res["train"]["solo_loss"] = float(log["gen_loss"])
        del state, step, log
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def tp_train_region_rank(ckpt, enc, dev):
    """[tp train 1024]: the flagship preset's generator step (LoRA 8 live,
    the frozen encoder stored bf16) on 1024-px regions (5334 tokens) with
    the encoder sharded over the ranks: K4 and K5 at 12 heads a rank, K2 at
    hidden 2048; one optimizer step of ACCUM microbatches of REGION_MICRO
    ([train 1024]'s first) with the launch counts at 0 and the all-reduces
    tallied; the replicated tensors' digest after it; then the first
    microbatch in f32 sharded at TP_REGION_F32_DEPTH blocks (K4's and K5's
    f32 paths; its launches counted too); on rank 0 the one-rank step's
    first microbatch, bf16 at full depth and f32 at those blocks: the loss
    and the LoRA q/v gradients against the sharded step's."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.parallel import make_mesh, shard_params
    from mipheivit_tpu_torch.parallel.sharding import param_layouts
    from mipheivit_tpu_torch.parallel.workers import digest

    rank = dist.get_rank()
    mesh = make_mesh(1, PAR_RANKS)
    model = shard_params(train_model(ckpt, enc, REGION, dev), mesh)
    data = train_batches(ACCUM, REGION_MICRO, REGION, dev, SEED + 4)
    state, step = train_setup(model, dev, torch.bfloat16, mesh=mesh)
    metrics = PixelMetrics.zeros(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    losses, step_s = [], []
    with all_reduce_tally() as tally:
        for a, batch in enumerate(data):
            t0 = time.perf_counter()
            state, metrics, log = step(state, batch, metrics)
            losses.append(float(log["gen_loss"]))
            step_s.append(time.perf_counter() - t0)
            if a == 0:
                grads0 = {n: g.detach().float().cpu() for n, g in log["grads"].items()}
    layouts = param_layouts(model)
    res = {"losses": losses, "step_s": step_s, "tally": tally,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "digest": digest({n: t for n, t in model.state_dict().items() if n not in layouts})}
    del state, step, model, log
    torch.cuda.empty_cache()
    # the same first microbatch in f32, sharded: rounding moves the gradients
    # by ~1e-7 there, where bf16's noise would hide a sharding fault
    got32 = one_step_grads(shard_params(train_model(ckpt, enc, REGION, dev,
                                                    depth=TP_REGION_F32_DEPTH), mesh),
                           data[0], dev, mesh=mesh)
    torch.cuda.synchronize()
    res["counts"] = read_counts()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        ref = one_step_grads(train_model(ckpt, enc, REGION, dev), data[0], dev, torch.bfloat16)
        torch.cuda.empty_cache()
        ref32 = one_step_grads(train_model(ckpt, enc, REGION, dev, depth=TP_REGION_F32_DEPTH),
                               data[0], dev)
        res.update(cos=lora_cos((losses[0], grads0), ref), solo_loss=ref[0],
                   ratio=norm_ratio(grad_norms(grads0), grad_norms(ref[1])),
                   cos32=lora_cos(got32, ref32), loss32=(got32[0], ref32[0]),
                   ratio32=norm_ratio(grad_norms(got32[1]), grad_norms(ref32[1])))
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def parallel_rank_phases(tmp, ckpt, enc, ref_path, data_values):
    """Every multi-card phase on one rank, in order (each rank of the
    spawn runs this): [collectives], [seq shard wsi 1024], [seq shard
    2048], [train seq shard 1024], [trainer ddp], [tp forward], [tp train
    256], [tp int8 forward], [tp swin], [tp train 1024], then the NCCL
    probe."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mipheivit_tpu_torch.parallel.mesh import process_device

    dev = process_device()
    res = {"collectives": collectives_rank(dev)}
    res["seq wsi"] = seq_wsi_rank(ckpt, enc, ref_path, dev)
    res["seq 2048"] = seq_2048_rank(ckpt, enc, dev)
    res["train seq"] = train_seq_rank(ckpt, enc, dev)
    res["trainer ddp"] = trainer_ddp_rank(tmp, ckpt, enc, data_values)
    res["tp forward"] = tp_forward_rank(ckpt, enc, dev)
    res["tp train"] = tp_train_rank(ckpt, enc, dev)
    res["tp int8"] = tp_int8_rank(ckpt, enc, dev)
    res["tp swin"] = tp_swin_rank(dev)
    res["tp train 1024"] = tp_train_region_rank(ckpt, enc, dev)
    res["nccl"] = nccl_probe(dev)
    return res


def parallel_phases(tmp: Path, ckpt: Path, enc: Path, wsi1024_out, data_values: dict,
                    trainer_ref: dict, depth: int) -> dict:
    """The multi-card paths over PAR_RANKS ranks spawned on cuda:0 (gloo),
    printed and checked here from every rank's results; returns the launch
    counts by path and rank."""
    from mipheivit_tpu_torch.parallel.spawn import spawn

    t_all = time.perf_counter()
    ref_path = tmp / "wsi1024.npy"
    np.save(ref_path, wsi1024_out)
    ranks = spawn(parallel_rank_phases, PAR_RANKS,
                  (str(tmp), str(ckpt), str(enc), str(ref_path), data_values),
                  device="cuda:0", backend="gloo", timeout=720, threads=None)
    r0 = ranks[0]
    counts = {}

    def per_rank(phase, tag):
        for r, res in enumerate(ranks):
            counts[f"{tag} r{r}"] = res[phase]["counts"]
        return "; ".join(f"rank {r} {counts_line(res[phase]['counts'])}"
                         for r, res in enumerate(ranks))

    c = r0["collectives"]
    print(f"[collectives] {PAR_RANKS} ranks on one card, backend {c['backend']} (NCCL "
          f"{r0['nccl']}): CUDA tensors of the k|v of a 1024-px block, {c['bytes'] / 1e6:.1f} MB "
          f"whole: all_gather_into_tensor {c['all_gather_ms']:.2f} ms, reduce_scatter_tensor "
          f"{c['reduce_scatter_ms']:.2f} ms, all_reduce {c['all_reduce_ms']:.2f} ms (median "
          f"of {COLLECTIVE_REPS}, wall, rank 0); gathered shards in place {c['gather_ok']}",
          flush=True)
    check(c["gather_ok"], "[collectives] the gathered shards are out of place")
    check(c["backend"] == "gloo", f"[collectives] backend {c['backend']}")

    w = r0["seq wsi"]
    windows, rows = w["windows"], -(-REGION_S // PAR_RANKS)
    print(f"[seq shard wsi 1024] wsi_inference(seq_shard_mesh) over the {SLIDE}^2 slide: "
          f"{windows} windows of {REGION} px, {SEQ_WSI_BATCH} a forward, tokens "
          f"{REGION_S} over {PAR_RANKS} ranks ({rows} a rank), wall "
          f"{w['wall_s']:.2f} s = {windows / w['wall_s']:.3f} windows/s; against [wsi 1024]'s "
          f"unsharded stitch max diff {w['diff']} uint8 step(s) (target <= 1); K4 query shard "
          f"{rows} x {REGION_S} {w['rect_ms']:.3f} ms vs square {REGION_S} x "
          f"{REGION_S} {w['square_ms']:.3f} ms (bound {w['rect_bound'][0]:.3f} ms, "
          f"{w['rect_bound'][1]}); {per_rank('seq wsi', 'seq shard wsi 1024')}", flush=True)
    check(w["diff"] <= 1, "[seq shard wsi 1024] differs from the unsharded stitch")
    for r, res in enumerate(ranks):
        check_counts(f"[seq shard wsi 1024] rank {r}", res["seq wsi"]["counts"],
                     k4=depth * windows, k2=depth * windows, k3=windows)

    q = w["int8"]
    for r, res in enumerate(ranks):
        counts[f"seq shard int8 r{r}"] = res["seq wsi"]["int8"]["counts"]
    print(f"[seq shard int8] the same sharded generator in int8 W8A8 over the slide's top-left "
          f"{INT8_SEQ_SLIDE}^2: {q['windows']} windows of {REGION} px, wall {q['wall_s']:.2f} s = "
          f"{q['windows'] / q['wall_s']:.3f} windows/s vs float sharded "
          f"{windows / w['wall_s']:.3f} ([seq shard wsi 1024]); per-marker Pearson vs the float "
          f"sharded serial stitch before the uint8 cast min {q['pearson'].min():.5f} (target >= "
          f"{INT8_SEQ_PEARSON}), after it min {q['pearson_uint8'].min():.5f}; the pipeline vs its "
          f"serial stitch max "
          f"diff {q['serial_diff']} uint8 step(s) (target <= 1); against the same int8 "
          f"generator's unsharded serial stitch: per-marker Pearson before the uint8 cast min "
          f"{q['solo_pearson'].min():.6f} (target >= {INT8_SOLO_PEARSON}), the pipeline's slide "
          f"max diff {q['solo_diff']} uint8 step(s) (target <= 1); "
          + "; ".join(f"rank {r} {counts_line(res['seq wsi']['int8']['counts'])}"
                      for r, res in enumerate(ranks)), flush=True)
    check(bool((q["pearson"] >= INT8_SEQ_PEARSON).all()),
          "[seq shard int8] the int8 stitch does not track the float one")
    check(q["serial_diff"] <= 1, "[seq shard int8] the pipeline differs from its serial stitch")
    check(bool((q["solo_pearson"] >= INT8_SOLO_PEARSON).all()) and q["solo_diff"] <= 1,
          "[seq shard int8] the sharded int8 stitch differs from the unsharded int8 one")
    for r, res in enumerate(ranks):
        check_counts(f"[seq shard int8] rank {r}", res["seq wsi"]["int8"]["counts"],
                     k4=depth * q["windows"], k3=q["windows"])

    s = r0["seq 2048"]
    peaks = ", ".join(f"{res['seq 2048']['peak_gib']:.2f}" for res in ranks)
    print(f"[seq shard 2048] one {SEQ_REGION}-px region, {s['tokens']} tokens over "
          f"{PAR_RANKS} ranks, bf16 forward: sharded {s['s']:.2f} s, peak {peaks} GiB by rank; "
          f"unsharded on rank 0 {s['solo_s']:.2f} s, peak {s['solo_peak_gib']:.2f} GiB; "
          f"per-marker Pearson sharded vs unsharded min {s['pearson'].min():.6f} (target >= "
          f"{SEQ_PEARSON}); {per_rank('seq 2048', 'seq shard 2048')}", flush=True)
    check(all(res["seq 2048"]["finite"] for res in ranks), "[seq shard 2048] non-finite output")
    check(bool((s["pearson"] >= SEQ_PEARSON).all()), "[seq shard 2048] sharded != unsharded")
    for r, res in enumerate(ranks):
        check_counts(f"[seq shard 2048] rank {r}", res["seq 2048"]["counts"], k4=depth,
                     k2=depth, k3=1)

    t = r0["train seq"]
    cos, least, worst = t["cos"]
    n_micro = 2 * ACCUM
    peaks = ", ".join(f"{res['train seq']['peak_gib']:.2f}" for res in ranks)
    print(f"[train seq shard 1024] {n_micro} microbatches of {REGION_MICRO} x {REGION} px over "
          f"{PAR_RANKS} ranks, 2 optimizer steps: steps "
          f"{', '.join(f'{1e3 * v:.1f}' for v in t['step_s'])} ms (first includes warm-up) = "
          f"{ACCUM * REGION_MICRO / t['step_s'][-1]:.3f} regions/s; peak {peaks} GiB by rank; "
          f"loss {', '.join(f'{v:.4f}' for v in t['losses'])} (one rank {t['solo_loss']:.4f}); "
          f"LoRA q/v grad cosine against the one-rank step {cos:.6f}, least one {least:.6f} "
          f"({worst}; target >= {SEQ_LORA_COS}); reduced gradient norm over the one-rank "
          f"step's: LoRA {t['norm_ratio']['lora']:.6f}, decoder "
          f"{t['norm_ratio']['decoder']:.6f} (target within {GRAD_NORM_TOL:g} of 1); "
          f"replicas identical "
          f"{len({res['train seq']['digest'] for res in ranks}) == 1}; "
          f"{per_rank('train seq', 'train seq shard 1024')}", flush=True)
    check(all(np.isfinite(t["losses"])), "[train seq shard 1024] non-finite loss")
    check(cos >= SEQ_LORA_COS, "[train seq shard 1024] gradients differ from one rank's")
    check(all(abs(v - 1) <= GRAD_NORM_TOL for v in t["norm_ratio"].values()),
          "[train seq shard 1024] the reduced gradient is scaled")
    check(len({res["train seq"]["digest"] for res in ranks}) == 1,
          "[train seq shard 1024] the replicas differ")
    for r, res in enumerate(ranks):
        check_counts(f"[train seq shard 1024] rank {r}", res["train seq"]["counts"],
                     k4=depth * n_micro, k5=depth * n_micro, k2=depth * n_micro,
                     k2b=depth * n_micro)

    d = r0["trainer ddp"]
    rel = abs(d["loss"] - trainer_ref["loss"]) / abs(trainer_ref["loss"])
    ratios = [norm_ratio(res["trainer ddp"]["grad_norms"], trainer_ref["grad_norms"])
              for res in ranks]
    ratio_text = "; ".join(f"rank {r} LoRA {q['lora']:.6f}, decoder {q['decoder']:.6f}"
                           for r, q in enumerate(ratios))
    rates = ", ".join(f"{res['trainer ddp']['rate']:.2f}" for res in ranks)
    print(f"[trainer ddp] train_patchgan, flagship preset at {IMG} px, {depth} blocks, "
          f"{PAR_RANKS} ranks x {DDP_BATCH} rows (global {DDP_BATCH * PAR_RANKS}) x "
          f"accumulation 2, {TRAINER_STEPS} microbatches: {d['s']:.1f} s; steady "
          f"{rates} images/s by rank's events (global batch) vs [trainer] {trainer_ref['rate']:.2f} images/s (both ranks "
          f"share the card); epoch loss {d['loss']:.6f} vs [trainer] {trainer_ref['loss']:.6f} "
          f"(rel {rel:.2e}, tol {DDP_LOSS_RTOL:g}); first step's reduced gradient norm over "
          f"[trainer]'s: {ratio_text} "
          f"(target within {GRAD_NORM_TOL:g} of 1); val_gen_loss_sim {d['val']:.4f}; replicas "
          f"identical {len({res['trainer ddp']['digest'] for res in ranks}) == 1}; rank 0 "
          f"wrote {d['metric_lines']} metrics lines, status {d['status']!r}, files "
          f"{d['files']}; {per_rank('trainer ddp', 'trainer ddp')}", flush=True)
    check(len({res["trainer ddp"]["digest"] for res in ranks}) == 1,
          "[trainer ddp] the replicas differ")
    check(rel <= DDP_LOSS_RTOL, "[trainer ddp] the loss differs from one process's")
    check(all(abs(v - 1) <= GRAD_NORM_TOL for q in ratios for v in q.values()),
          "[trainer ddp] the reduced gradient is scaled")
    check(d["status"] == "finished" and d["metric_lines"] == 2
          and d["files"] == ["config.yaml", "metrics.jsonl", "status.txt"],
          "[trainer ddp] rank 0's files")
    check(all(res["trainer ddp"]["step"] == TRAINER_STEPS for res in ranks),
          "[trainer ddp] steps")
    # 4 microbatches; val and test: 16 tiles each over 2 ranks, 2 batches of 4
    n_fwd = TRAINER_STEPS + 2 * (TRAINER_TILES["val"] // (PAR_RANKS * DDP_BATCH))
    for r, res in enumerate(ranks):
        check_counts(f"[trainer ddp] rank {r}", res["trainer ddp"]["counts"], k1=depth * n_fwd,
                     k2=depth * n_fwd, k2b=depth * TRAINER_STEPS)
    tp_report(ranks, depth, per_rank, counts, t_all)
    return counts


def tp_report(ranks, depth: int, per_rank, counts: dict, t_all: float) -> None:
    """Print and check [tp forward], [tp train 256], [tp int8 forward], [tp
    swin] and [tp train 1024] from every rank's results (``per_rank(phase,
    tag)`` records a phase's launch counts by path and rank into
    ``counts`` and returns their text)."""
    r0 = ranks[0]

    f = r0["tp forward"]
    n_ar = 2 * depth                 # a row-split proj and fc2 a block
    least = {k: min(float(res["tp forward"]["pearson"][k].min()) for res in ranks)
             for k in ("tiles", "region")}
    print(f"[tp forward] shard_params over {PAR_RANKS} ranks ({HEADS // PAR_RANKS} heads and "
          f"SwiGLU hidden {FC1_H // PAR_RANKS} a rank), bf16: {TP_TILES} tiles of {IMG} px "
          f"{f['tiles_ms']:.1f} ms a forward with {n_ar} all-reduces of "
          f"{f['tiles_bytes'] / 1e6:.1f} MB, one alone {f['tiles_allreduce_ms']:.2f} ms (x "
          f"{n_ar} = {n_ar * f['tiles_allreduce_ms']:.1f} ms); one {REGION}-px region "
          f"({REGION_S} tokens) {f['region_ms']:.1f} ms with {n_ar} of "
          f"{f['region_bytes'] / 1e6:.1f} MB, one alone {f['region_allreduce_ms']:.2f} ms (x "
          f"{n_ar} = {n_ar * f['region_allreduce_ms']:.1f} ms) (wall, median of {TP_REPS} and "
          f"{COLLECTIVE_REPS}, rank 0; both ranks share the card: not a multi-card rate); "
          f"per-marker Pearson against the unsharded forward, least over ranks: "
          f"tiles {least['tiles']:.6f}, region {least['region']:.6f} (target >= {TP_PEARSON}); "
          f"f32 at 2 blocks against the CPU's plain chain {f['f32_rel']:.2e} of max|ref| "
          f"(target <= {TP_F32_TOL:g}); {per_rank('tp forward', 'tp forward')}", flush=True)
    check(all(res["tp forward"]["finite"] for res in ranks), "[tp forward] non-finite output")
    check(min(least.values()) >= TP_PEARSON, "[tp forward] sharded != unsharded")
    check(f["f32_rel"] <= TP_F32_TOL, "[tp forward] f32 sharded differs from the CPU")
    for r, res in enumerate(ranks):
        # one tile batch (K1, K2, K3) and one region (K4, K2, K3)
        check_counts(f"[tp forward] rank {r}", res["tp forward"]["counts"], k1=depth,
                     k2=2 * depth, k3=2, k4=depth)

    t = r0["tp train"]
    cos, least_cos, worst = t["cos"]
    cos32, least32, worst32 = t["cos32"]
    rel = abs(t["losses"][0] - t["solo_loss"]) / abs(t["solo_loss"])
    rel32 = abs(t["loss32"][0] - t["loss32"][1]) / abs(t["loss32"][1])
    n_micro = 2 * ACCUM
    peaks = ", ".join(f"{res['tp train']['peak_gib']:.2f}" for res in ranks)
    same = len({res["tp train"]["digest"] for res in ranks}) == 1
    # a doubled or halved gradient shows in f32; bf16's ratio is printed
    ratios = list(t["ratio32"].values())
    print(f"[tp train 256] the flagship preset's step with its encoder sharded over "
          f"{PAR_RANKS} ranks ({t['shards']} sharded tensors a rank): {n_micro} microbatches of "
          f"{MICRO} x {IMG} px, 2 optimizer steps: steps "
          f"{', '.join(f'{1e3 * v:.1f}' for v in t['step_s'])} ms (first includes warm-up); "
          f"peak {peaks} GiB by rank; loss {', '.join(f'{v:.4f}' for v in t['losses'])}; first "
          f"against one rank's {t['solo_loss']:.4f} (rel {rel:.2e}, tol {TP_LOSS_RTOL:g}); bf16 "
          f"LoRA q/v grad cosine against the one-rank step {cos:.6f}, least one "
          f"{least_cos:.6f} ({worst}; target >= {TP_BF16_LORA_COS}; the one-rank step against "
          f"itself {t['again_cos'][0]:.6f}, loss {t['again_loss']:.6f}); f32, first microbatch: "
          f"loss {t['loss32'][0]:.6f} vs {t['loss32'][1]:.6f} (rel {rel32:.2e}, tol "
          f"{TP_F32_LOSS_RTOL:g}), LoRA q/v cosine {cos32:.7f}, least one {least32:.7f} "
          f"({worst32}; target >= {TP_F32_LORA_COS}); reduced gradient norm over the one-rank "
          f"step's: bf16 LoRA {t['ratio']['lora']:.6f}, decoder {t['ratio']['decoder']:.6f}, "
          f"f32 LoRA {t['ratio32']['lora']:.6f}, decoder {t['ratio32']['decoder']:.6f} (f32 "
          f"target within {GRAD_NORM_TOL:g} of 1); replicated tensors identical {same}; "
          f"{per_rank('tp train', 'tp train 256')}", flush=True)
    check(all(np.isfinite(t["losses"])), "[tp train 256] non-finite loss")
    check(rel <= TP_LOSS_RTOL, "[tp train 256] the loss differs from one rank's")
    check(cos >= TP_BF16_LORA_COS, "[tp train 256] bf16 gradients differ from one rank's")
    check(rel32 <= TP_F32_LOSS_RTOL and cos32 >= TP_F32_LORA_COS,
          "[tp train 256] f32 gradients differ from one rank's")
    check(all(abs(v - 1) <= GRAD_NORM_TOL for v in ratios),
          "[tp train 256] the reduced gradient is scaled")
    check(same, "[tp train 256] the replicated tensors differ between the ranks")
    for r, res in enumerate(ranks):
        check_counts(f"[tp train 256] rank {r}", res["tp train"]["counts"], k1=depth * n_micro,
                     k2=depth * n_micro, k2b=depth * n_micro)

    q = r0["tp int8"]
    least = {k: min(float(res["tp int8"]["pearson"][k].min()) for res in ranks)
             for k in ("tiles", "region")}
    equal = {k: min(res["tp int8"]["uint8_equal"][k] for res in ranks) for k in least}
    print(f"[tp int8 forward] quantize_encoder then shard_params over {PAR_RANKS} ranks (int8 "
          f"qkv and fc1 cut with their scales; proj and fc2 row-split: the rows' amax "
          f"max-reduced, the int32 partial products summed): {TP_TILES} tiles of {IMG} px "
          f"{1e3 * q['s']['tiles']:.1f} ms with {tally_text(q['tally']['tiles'])}; one "
          f"{REGION}-px region {1e3 * q['s']['region']:.1f} ms with "
          f"{tally_text(q['tally']['region'])} (wall of the counted forward, rank 0); one "
          f"block's int32 sum alone ({q['int32_bytes'] / 1e6:.1f} MB) {q['int32_ms']:.2f} ms, its "
          f"row-scale max ({q['max_bytes'] / 1e3:.1f} kB) {q['max_ms']:.2f} ms; per-marker "
          f"Pearson against the unsharded int8 forward, least over ranks: tiles "
          f"{least['tiles']:.6f}, region {least['region']:.6f} (target >= {TP_PEARSON}); "
          f"uint8 codes equal: tiles {equal['tiles']:.6f}, region {equal['region']:.6f}; "
          f"{per_rank('tp int8', 'tp int8 forward')}", flush=True)
    check(all(res["tp int8"]["finite"] for res in ranks), "[tp int8 forward] non-finite output")
    check(min(least.values()) >= TP_PEARSON, "[tp int8 forward] sharded != unsharded")
    for r, res in enumerate(ranks):
        # one tile batch (K1, K3) and one region (K4, K3); fc1 is an int8 product
        check_counts(f"[tp int8 forward] rank {r}", res["tp int8"]["counts"], k1=depth, k3=2,
                     k4=depth)

    w = r0["tp swin"]
    t = w["train"]
    least_w = {k: min(float(res["tp swin"][k].min()) for res in ranks)
               for k in ("pearson32", "pearson", "bf16_vs_f32", "floor")}
    f32_rel = max(res["tp swin"]["f32_rel"] for res in ranks)
    rel = abs(t["losses"][0] - t["solo_loss"]) / abs(t["solo_loss"])
    same = len({res["tp swin"]["train"]["digest"] for res in ranks}) == 1
    heads = [res["tp swin"]["heads"] for res in ranks]
    print(f"[tp swin] unet_lora on ctranspath sharded over {PAR_RANKS} ranks (heads a block, "
          f"by rank: {'; '.join(','.join(map(str, h)) for h in heads)}; the Swin MLP whole): "
          f"bf16 forward of {TP_TILES} tiles {1e3 * w['s']:.1f} ms with "
          f"{tally_text(w['tally'])}; f32 against the unsharded f32 forward: per-marker Pearson, "
          f"least over ranks, {least_w['pearson32']:.7f} (target >= {TP_PEARSON}), max |diff| "
          f"{f32_rel:.2e} of max |ref| (target <= {TP_F32_TOL:g}); bf16 against the unsharded "
          f"f32 forward {least_w['bf16_vs_f32']:.6f} (target >= {MIN_PEARSON}, the bf16-vs-f32 "
          f"bar; the unsharded bf16 forward's {least_w['floor']:.6f}), against the unsharded "
          f"bf16 forward {least_w['pearson']:.6f} (output spread ~0.01: bf16's step at the "
          f"outputs is a large share of it); the preset's step, 2 microbatches "
          f"of {TP_SWIN_MICRO} x {IMG} px ({t['shards']} sharded of {t['trainable']} trainable "
          f"tensors a rank): {', '.join(f'{1e3 * v:.1f}' for v in t['step_s'])} ms (first "
          f"includes warm-up), {tally_text(t['tally'])}, peak "
          f"{', '.join(f'{res['tp swin']['train']['peak_gib']:.2f}' for res in ranks)} GiB by "
          f"rank; loss {', '.join(f'{v:.4f}' for v in t['losses'])}, first against one rank's "
          f"{t['solo_loss']:.4f} (rel {rel:.2e}, tol {TP_LOSS_RTOL:g}); replicated tensors "
          f"identical {same}; {per_rank('tp swin', 'tp swin')}; "
          + "; ".join(f"rank {r} step {counts_line(res['tp swin']['train']['counts'])}"
                      for r, res in enumerate(ranks)), flush=True)
    check(all(res["tp swin"]["finite"] for res in ranks), "[tp swin] non-finite output")
    check(least_w["pearson32"] >= TP_PEARSON and f32_rel <= TP_F32_TOL,
          "[tp swin] the f32 sharded forward differs from the unsharded one")
    check(least_w["bf16_vs_f32"] >= MIN_PEARSON, "[tp swin] the bf16 sharded forward does not "
          "track f32")
    check(all(np.isfinite(t["losses"])), "[tp swin] non-finite loss")
    check(rel <= TP_LOSS_RTOL, "[tp swin] the loss differs from one rank's")
    check(same, "[tp swin] the replicated tensors differ between the ranks")
    check(heads[0] != heads[1] and [a + b for a, b in zip(*heads)] == [3, 3, 6, 6] + [12] * 6
          + [24, 24], f"[tp swin] heads by rank {heads}")
    for r, res in enumerate(ranks):
        counts[f"tp swin train r{r}"] = res["tp swin"]["train"]["counts"]
        check_counts(f"[tp swin] rank {r}", res["tp swin"]["counts"])
        check_counts(f"[tp swin] step, rank {r}", res["tp swin"]["train"]["counts"])

    tp_region_report(ranks, depth, per_rank, t_all)


def tp_region_report(ranks, depth: int, per_rank, t_all: float) -> None:
    """Print and check [tp train 1024] from every rank's results (as
    ``tp_report``)."""
    t = ranks[0]["tp train 1024"]
    cos, least_cos, worst = t["cos"]
    cos32, least32, worst32 = t["cos32"]
    rel = abs(t["losses"][0] - t["solo_loss"]) / abs(t["solo_loss"])
    rel32 = abs(t["loss32"][0] - t["loss32"][1]) / abs(t["loss32"][1])
    same = len({res["tp train 1024"]["digest"] for res in ranks}) == 1
    peaks = ", ".join(f"{res['tp train 1024']['peak_gib']:.2f}" for res in ranks)
    print(f"[tp train 1024] the flagship preset's step on {REGION}-px regions ({REGION_S} "
          f"tokens) with its encoder sharded over {PAR_RANKS} ranks (K4 and K5 at "
          f"{HEADS // PAR_RANKS} heads, K2 at hidden {FC1_H // PAR_RANKS}): {ACCUM} "
          f"microbatches of {REGION_MICRO}, one optimizer step: "
          f"{', '.join(f'{1e3 * v:.1f}' for v in t['step_s'])} ms (first includes warm-up), "
          f"{tally_text(t['tally'])}; peak {peaks} GiB by rank; loss "
          f"{', '.join(f'{v:.4f}' for v in t['losses'])}, first against one rank's "
          f"{t['solo_loss']:.4f} (rel {rel:.2e}, tol {TP_LOSS_RTOL:g}); bf16 LoRA q/v grad "
          f"cosine against the one-rank step {cos:.6f}, least one {least_cos:.6f} ({worst}; "
          f"target >= {TP_BF16_LORA_COS}); f32 at {TP_REGION_F32_DEPTH} blocks, first "
          f"microbatch: loss {t['loss32'][0]:.6f} vs {t['loss32'][1]:.6f} (rel {rel32:.2e}, tol "
          f"{TP_F32_LOSS_RTOL:g}), LoRA q/v cosine {cos32:.7f}, least one {least32:.7f} "
          f"({worst32}; target >= {TP_F32_LORA_COS}); reduced gradient norm over the one-rank "
          f"step's: bf16 LoRA {t['ratio']['lora']:.6f}, decoder {t['ratio']['decoder']:.6f}, "
          f"f32 LoRA {t['ratio32']['lora']:.6f}, decoder {t['ratio32']['decoder']:.6f} (f32 "
          f"target within {GRAD_NORM_TOL:g} of 1); replicated tensors identical {same}; "
          f"{per_rank('tp train 1024', 'tp train 1024')} "
          f"({time.perf_counter() - t_all:.1f} s for the spawned phases)", flush=True)
    check(all(np.isfinite(t["losses"])), "[tp train 1024] non-finite loss")
    check(rel <= TP_LOSS_RTOL, "[tp train 1024] the loss differs from one rank's")
    check(cos >= TP_BF16_LORA_COS, "[tp train 1024] bf16 gradients differ from one rank's")
    check(rel32 <= TP_F32_LOSS_RTOL and cos32 >= TP_F32_LORA_COS,
          "[tp train 1024] f32 gradients differ from one rank's")
    check(all(abs(v - 1) <= GRAD_NORM_TOL for v in t["ratio32"].values()),
          "[tp train 1024] the reduced gradient is scaled")
    check(same, "[tp train 1024] the replicated tensors differ between the ranks")
    # the bf16 optimizer step, then the f32 microbatch at TP_REGION_F32_DEPTH blocks
    n_blocks = depth * ACCUM + TP_REGION_F32_DEPTH
    for r, res in enumerate(ranks):
        check_counts(f"[tp train 1024] rank {r}", res["tp train 1024"]["counts"],
                     k4=n_blocks, k5=n_blocks, k2=n_blocks, k2b=n_blocks)


def serve_dp_phase(model, tiles, dev, depth):
    """[serve dp]: build_serving_fn with its batch split over two replicas
    on the one card (make_data_mesh(SERVE_BATCH, [cuda:0] * 2)) against one
    replica's answer on the same tiles."""
    from mipheivit_tpu_torch.infer.serve import build_serving_fn
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE
    from mipheivit_tpu_torch.parallel import make_data_mesh

    t0 = time.perf_counter()
    mesh = make_data_mesh(SERVE_BATCH, [dev] * PAR_RANKS)
    x = tiles[:SERVE_BATCH]
    solo_fn = build_serving_fn(model, HOPTIMUS_HE, IMG, SERVE_BATCH, dev)
    dp_fn = build_serving_fn(model, HOPTIMUS_HE, IMG, SERVE_BATCH, mesh=mesh)
    solo = solo_fn(x)
    reset_counts()
    got = dp_fn(x)
    torch.cuda.synchronize()
    counts = read_counts()
    diff = np.abs(got.astype(np.int16) - solo.astype(np.int16))
    ms = {name: 1e3 * float(np.median([_timed(fn, x) for _ in range(5)]))
          for name, fn in (("dp", dp_fn), ("solo", solo_fn))}
    print(f"[serve dp] build_serving_fn over {mesh.size} replicas on {dev} at batch "
          f"{SERVE_BATCH}: {ms['dp']:.1f} ms a batch vs one replica {ms['solo']:.1f} ms "
          f"(wall, median of 5; the replicas share the card); against one replica max diff "
          f"{int(diff.max())} uint8 step(s) on {int((diff > 0).sum())} of {diff.size} values "
          f"(target <= 1); {counts_line(counts)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(got.shape == solo.shape and int(diff.max()) <= 1, "[serve dp] differs from one replica")
    check_counts("[serve dp]", counts, k1=depth * mesh.size, k2=depth * mesh.size, k3=mesh.size)
    del dp_fn, solo_fn
    torch.cuda.empty_cache()
    return counts


def _timed(fn, x):
    t0 = time.perf_counter()
    fn(x)
    return time.perf_counter() - t0


# ---- int8 W8A8 serving (ops/quant.py: torch._int_mm, a library call) -------

# the flagship's four encoder GEMMs at a batch of 64 tiles (M 21 056): (name,
# K, N), and one M of at most 16 rows (torch._int_mm's CUDA path takes M > 16)
INT8_GEMMS = (("qkv", 1536, 4608), ("proj", 1536, 1536), ("fc1", 1536, 8192),
              ("fc2", 4096, 1536))
INT8_RAGGED_M = 9
# the four fusion blocks' convs at a batch of 64 256-px tiles: (C in, K out,
# H = W); the last one's 9C = 603 is not a multiple of 8
INT8_CONVS = ((1536 + 192, 256, 32), (256 + 96, 128, 64), (128 + 48, 64, 128),
              (64 + 3, 32, 256))
INT8_CHECK_ROWS = 256            # GEMM rows held against the CPU (first and last 128)
INT8_CHECK_TILES = 2             # a conv's tiles held against the CPU
# per-marker Pearson of the int8 forward against the bf16 forward of the same
# weights (tests/test_quant.py's gate), and of the sharded int8 stitch
# against the sharded float one (its test_int8_with_seq_shard_serving bound)
INT8_PEARSON, INT8_SEQ_PEARSON = 0.995, 0.99
# [seq shard int8]: the sharded int8 stitch against the same int8 model's
# unsharded one (per-marker Pearson before the uint8 cast; and <= 1 uint8 step)
INT8_SOLO_PEARSON = 0.9999
INT8_FAMILIES = {"quantize_rows": "quantize rows", "quantize_patches": "quantize patches",
                 "dequantize": "dequantize", "int_mm": "_int_mm"}
# [seq shard int8]: the top-left 1920^2 of the slide, 2 x 2 windows of 1024 px
INT8_SEQ_SLIDE = 1920


def bf16_steps(got, want) -> float:
    """The largest |got - want| in units of want's bf16 step (2**(e - 7) for
    |want| in [2**e, 2**(e + 1))): <= 1 is within one step."""
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return float(((got.float() - w).abs() / step).max())


def int8_gemm_case(name, m, k, n, seed, dev):
    """One int8_matmul on the card against its plain version on the CPU:
    weight and activation codes, the output on up to INT8_CHECK_ROWS rows,
    and the times of the op, of its _int_mm product alone (the weight as a
    column-major view, and row-major where _int_mm takes it), and of
    F.linear in bf16."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(n, k, device=dev, generator=g) * 0.02).to(torch.bfloat16)
    b = (torch.randn(n, device=dev, generator=g) * 0.02).to(torch.bfloat16)
    half = INT8_CHECK_ROWS // 2
    sel = torch.unique(torch.cat([torch.arange(min(m, half)), torch.arange(max(m - half, 0), m)]))
    with torch.inference_mode():
        w_i8, scale = quant.quantize_weight(w, axis=-1)
        w_cpu, s_cpu = quant.quantize_weight(w.cpu(), axis=-1)
        codes, _ = quant.quantize_rows(x)
        codes_ok = (torch.equal(w_i8.cpu(), w_cpu) and torch.equal(scale.cpu(), s_cpu)
                    and torch.equal(codes.cpu(), quant.quantize_rows(x.cpu())[0]))
        got = quant.int8_matmul(x, w_i8, scale, b)
        want = quant.int8_matmul_reference(x[sel.to(dev)].cpu(), w_cpu, s_cpu, b.cpu())
        steps = bf16_steps(got[sel.to(dev)].cpu(), want)
        ms = cuda_ms(lambda: quant.int8_matmul(x, w_i8, scale, b))
        mm_ms = cuda_ms(lambda: quant.int_mm(codes, w_i8))
        row_ms = None
        if m >= 17:
            w_rows = w_i8.t().contiguous()
            try:
                row_ms = cuda_ms(lambda: torch._int_mm(codes, w_rows))
            except RuntimeError as e:     # a layout _int_mm refuses
                row_ms = "refused: " + str(e).splitlines()[0][:80]
        library_ms = cuda_ms(lambda: F.linear(x, w, b))
    bnd, by = bound_ms(2 * m * k + n * k + 6 * n + 2 * m * n, 2.0 * m * n * k, "int8")
    row = f"{row_ms:.3f}" if isinstance(row_ms, float) else row_ms or "not timed (M <= 16)"
    print(f"[int8 ops] int8_matmul {name} M {m} K {k} N {n} bf16: weight and activation codes "
          f"card = CPU {codes_ok}; output vs the plain version on the CPU ({len(sel)} rows) "
          f"max {steps:.2f} bf16 steps (target <= 1); int8_matmul {ms:.3f} ms (its _int_mm "
          f"alone {mm_ms:.3f} ms with the weight column-major, row-major {row}), F.linear "
          f"bf16 {library_ms:.3f} ms, bound {bnd:.3f} ms ({by})", flush=True)
    check(codes_ok, f"[int8 ops] {name}: the card's int8 codes differ from the CPU's")
    check(steps <= 1.0, f"[int8 ops] {name}: int8_matmul differs from its plain version")
    return {"ms": ms, "int_mm_ms": mm_ms, "library_ms": library_ms, "bound_ms": bnd,
            "bound_by": by}


def int8_conv_case(c, k, hw, seed, dev):
    """One int8_conv3x3 at a fusion block's shape (BATCH tiles) on the card
    against its plain version on the CPU on INT8_CHECK_TILES tiles (each
    pixel's scale comes from its own tile): patch codes and output; the
    times of the op, its _int_mm product alone and cuDNN's conv2d in bf16."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.models.mipheivit import Int8Conv3x3
    from mipheivit_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(BATCH, c, hw, hw, device=dev, generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn(k, c, 3, 3, device=dev, generator=g) * 0.02).to(torch.bfloat16)
    t = INT8_CHECK_TILES
    with torch.inference_mode():
        conv = torch.nn.Conv2d(c, k, 3, padding=1, bias=False, device="meta")
        conv.weight = torch.nn.Parameter(w, requires_grad=False)
        twin = Int8Conv3x3.from_conv(conv)          # the model's [K, 9C'] layout
        w_i8, scale = twin.weight, twin.scale
        w_cpu, s_cpu = w_i8.cpu(), scale.cpu()
        patches, _ = quant.quantize_patches(x, quant.patch_width(c))
        want_codes, _ = quant.quantize_patches(x[:t].cpu())
        codes_ok = torch.equal(patches[:t * hw * hw, :9 * c].cpu(), want_codes)
        del want_codes
        got = quant.int8_conv3x3(x, w_i8, scale)
        want = quant.int8_conv3x3_reference(x[:t].cpu(), w_cpu, s_cpu)
        steps = bf16_steps(got[:t].cpu(), want)
        del got
        ms = cuda_ms(lambda: quant.int8_conv3x3(x, w_i8, scale))
        mm_ms = cuda_ms(lambda: quant.int_mm(patches, w_i8))
        del patches
        library_ms = cuda_ms(lambda: F.conv2d(x, w, padding=1))
    m = BATCH * hw * hw
    bnd, by = bound_ms(2 * m * c + 9 * c * k + 4 * k + 2 * m * k, 2.0 * m * k * 9 * c, "int8")
    print(f"[int8 ops] int8_conv3x3 [{BATCH}, {c}, {hw}, {hw}] -> {k} bf16 (9C {9 * c}): patch "
          f"codes card = CPU {codes_ok} ({t} tiles); output vs the plain version on the CPU max "
          f"{steps:.2f} bf16 steps (target <= 1); int8_conv3x3 {ms:.3f} ms (its _int_mm alone "
          f"{mm_ms:.3f} ms), cuDNN conv2d bf16 {library_ms:.3f} ms, bound {bnd:.3f} ms ({by})",
          flush=True)
    check(codes_ok, f"[int8 ops] conv C {c}: the card's patch codes differ from the CPU's")
    check(steps <= 1.0, f"[int8 ops] conv C {c}: int8_conv3x3 differs from its plain version")
    torch.cuda.empty_cache()
    return {"ms": ms, "int_mm_ms": mm_ms, "library_ms": library_ms, "bound_ms": bnd,
            "bound_by": by}


def int8_ops_phase(dev):
    """[int8 ops]: int8_matmul at the flagship's four GEMMs at 64 tiles and at
    a ragged M, int8_conv3x3 at the four fusion shapes of 64 tiles."""
    t0 = time.perf_counter()
    rows = {}
    for i, (name, k, n) in enumerate(INT8_GEMMS):
        rows[name] = int8_gemm_case(name, BATCH * 329, k, n, SEED + 130 + i, dev)
    rows["qkv ragged"] = int8_gemm_case("qkv ragged", INT8_RAGGED_M, 1536, 4608, SEED + 135, dev)
    torch.cuda.empty_cache()
    for i, (c, k, hw) in enumerate(INT8_CONVS):
        rows[f"fusion{i}"] = int8_conv_case(c, k, hw, SEED + 140 + i, dev)
    print(f"[int8 ops] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def int8_device_split(fn, reps: int = 3) -> dict:
    """Device ms of one ``fn()`` by op family, from a profiler trace of
    ``reps`` calls: the int8 quantise passes, ``_int_mm``, the dequantise
    passes (the kernels inside the device-side ranges of record_function
    ranges wrapped around ``ops.quant``'s helpers for the trace only), K1,
    K3 (by kernel name) and the rest; None for the three int8 families if
    the trace holds no device-side range."""
    import bisect

    from torch.profiler import ProfilerActivity, profile, record_function

    from mipheivit_tpu_torch.ops import quant

    def wrap(label, f):
        def annotated(*args, **kwargs):
            with record_function(f"int8.{label}"):
                return f(*args, **kwargs)
        return annotated

    fn()
    torch.cuda.synchronize()
    saved = {name: getattr(quant, name) for name in INT8_FAMILIES}
    try:
        for name, label in INT8_FAMILIES.items():
            setattr(quant, name, wrap(label, saved[name]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    finally:
        for name, f in saved.items():
            setattr(quant, name, f)
    device = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    ranges = sorted((ev.time_range.start, ev.time_range.end, ev.name[len("int8."):])
                    for ev in device if ev.name.startswith("int8."))
    starts = [r[0] for r in ranges]
    split = {label: 0.0 for label in INT8_FAMILIES.values()}
    split.update({"K1": 0.0, "K3": 0.0, "rest": 0.0, "total": 0.0})
    for ev in device:
        if ev.name.startswith("int8."):
            continue
        t0, t1, us = ev.time_range.start, ev.time_range.end, ev.time_range.elapsed_us()
        split["total"] += us
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t1 <= ranges[i][1]:
            split[ranges[i][2]] += us
        elif "attn_bf16_kernel" in ev.name:
            split["K1"] += us
        elif "heads_ws_kernel" in ev.name:
            split["K3"] += us
        else:
            split["rest"] += us
    out = {key: v / reps / 1e3 for key, v in split.items()}
    if not ranges:
        out.update({label: None for label in INT8_FAMILIES.values()})
    return out

def serving_config(tmp: Path, ckpt: Path, enc: Path):
    """The flagship preset's run config for ``load_serving_model``: the
    smoke's checkpoint dir and encoder file, a channel-statistics file."""
    stats = tmp / "serving_channel_stats.json"
    stats.write_text(json.dumps({"RGB": {"mean": [180.0, 140.0, 170.0],
                                         "std": [40.0, 45.0, 35.0]}}))
    return trainer_config({"data.channel_stats_path": str(stats),
                           "model.encoder.encoder_weights": str(enc)})


def model_gib(model) -> float:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers())) / 2 ** 30


def throughput_int8_phase(tmp: Path, ckpt: Path, enc: Path, x, pred_bf16, bf16: dict, dev):
    """[throughput int8]: the flagship loaded as the CLI's --int8 loads it
    (load_serving_model -> quantize_encoder -> quantize_decoder), one forward
    of the 64 tiles with the launch counts at 0 and the peak memory, per-marker
    Pearson against the bf16 forward of the same weights, the steady
    tiles/s and the device time by op family. Returns the model and the
    counts."""
    from mipheivit_tpu_torch.infer import load_serving_model, quantize_decoder, quantize_encoder

    t0 = time.perf_counter()
    model, _ = load_serving_model(serving_config(tmp, ckpt, enc), str(ckpt), (IMG, IMG),
                                  MARKERS, dev)
    quantize_decoder(quantize_encoder(model))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    depth = model.vit_cfg.depth
    with torch.inference_mode():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        pred = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
        split = int8_device_split(lambda: model(x))
    pred = pred.cpu().numpy()
    r = pearson(pred, pred_bf16)
    parts = ", ".join(f"{key} " + ("not measured" if split[key] is None else f"{split[key]:.2f}")
                      for key in ("_int_mm", "quantize rows", "quantize patches", "dequantize",
                                  "K1", "K3", "rest"))
    print(f"[throughput int8] load_serving_model -> quantize_encoder -> quantize_decoder in "
          f"{load_s:.1f} s ({model_gib(model):.2f} GiB of weights, bf16 {bf16['weights_gib']:.2f}); "
          f"{BATCH * 1000 / fwd_ms:.1f} tiles/s steady int8 forward at batch {BATCH} "
          f"({fwd_ms:.2f} ms/batch, CUDA events, median of 10) vs [throughput] bf16 "
          f"{BATCH * 1000 / bf16['ms']:.1f} ({bf16['ms']:.2f} ms); peak {peak:.2f} GiB vs bf16 "
          f"{bf16['peak_gib']:.2f}; device ms a batch by family (profiler): {parts} of "
          f"{split['total']:.2f}; per-marker Pearson vs the bf16 forward min {r.min():.5f} "
          f"(target >= {INT8_PEARSON}); {counts_line(counts)} on {card_line()}", flush=True)
    check(bool(np.isfinite(pred).all()), "[throughput int8] non-finite output")
    check(bool((r >= INT8_PEARSON).all()), "[throughput int8] int8 does not track bf16")
    check_counts("[throughput int8]", counts, k1=depth, k3=1)
    return model, counts


def wsi_int8_phase(name, model, image, tile, overlap, batch, device, float_out, float_stats):
    """``wsi_phase`` on the int8 model (the pipeline against its serial
    stitch), then per-marker Pearson of its stitch against the bf16 one's,
    before the uint8 cast (gated) and after it (printed). The smoke's
    random-weight maps span a few uint8 steps, so a one-step flip of the
    cast weighs on the uint8 Pearson; the spread is printed beside it."""
    counts, stats, out = wsi_phase(name, model, image, tile, overlap, batch, device)
    ref = np.moveaxis(float_stats["stitch_f32"], 0, -1)
    r = pearson(np.moveaxis(stats.pop("stitch_f32"), 0, -1), ref)
    r8 = pearson(np.moveaxis(out, 0, -1), np.moveaxis(float_out, 0, -1))
    spread = ref.reshape(-1, MARKERS).std(0)
    steps = np.abs(out.astype(np.int16) - float_out.astype(np.int16))

    def rates(st):
        steady = st["steady_tiles"] / st["steady_s"] if st["steady_s"] > 0 else float("nan")
        return f"{st['n_tiles'] / st['wall_s']:.2f} wall, {steady:.2f} steady"

    print(f"[{name}] windows/s {rates(stats)} vs bf16 {rates(float_stats)}; per-marker "
          f"Pearson vs the bf16 stitch before the uint8 cast min {r.min():.5f} (target >= "
          f"{INT8_PEARSON}), after it min {r8.min():.5f} (the bf16 maps' std "
          f"{spread.min():.2f}-{spread.max():.2f} uint8 steps); uint8 |int8 - bf16| median "
          f"{np.median(steps):.0f}, within 1 step {np.mean(steps <= 1):.4f}, max "
          f"{int(steps.max())}", flush=True)
    check(bool((r >= INT8_PEARSON).all()), f"[{name}] the int8 slide does not track bf16")
    return counts

def wsi_dp_phase(model, slide, want, dev, depth):
    """[wsi dp]: wsi_inference with each batch of 256-px windows split over
    two replicas on the one card, against [wsi 256]'s stitch."""
    from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE
    from mipheivit_tpu_torch.parallel import make_data_mesh

    mesh = make_data_mesh(BATCH, [dev] * PAR_RANKS)
    out = np.zeros_like(want)
    stats = {}
    t0 = time.perf_counter()
    reset_counts()
    wsi_inference(model, ArraySlide(slide), out, [f"m{i}" for i in range(MARKERS)],
                  HOPTIMUS_HE, tile_size=IMG, overlap=64, batch_size=BATCH, tissue_only=False,
                  stats=stats, mesh=mesh)
    torch.cuda.synchronize()
    counts = read_counts()
    diff = int(np.abs(out.astype(np.int16) - want.astype(np.int16)).max())
    n_batches = stats["n_batches"]
    print(f"[wsi dp] wsi_inference(mesh) over {mesh.size} replicas on {dev}: "
          f"{stats['n_tiles']} windows of {IMG} px in {n_batches} batches of {BATCH}, wall "
          f"{stats['wall_s']:.3f} s = {stats['n_tiles'] / stats['wall_s']:.2f} windows/s; "
          f"against [wsi 256]'s stitch max diff {diff} uint8 step(s) (target <= 1); "
          f"{counts_line(counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(diff <= 1, "[wsi dp] differs from the one-replica stitch")
    n = n_batches * mesh.size
    check_counts("[wsi dp]", counts, k1=depth * n, k2=depth * n, k3=n)
    torch.cuda.empty_cache()
    return counts


CONSUMER_TILES = 64              # [embeddings]: two batches of 32 at 224 px
CONSUMER_MAP_TILES = 8           # [embedding map]: tiles per split
CONSUMER_HEMIT_TILES = 8         # [inference hemit]: 256-px pairs, batches of 4
# a uint8 output's per-marker Pearson against the CPU's f32 prediction, at
# most this far below that of the CPU's own uint8 of it (the quantisation
# alone costs up to ~1e-2 where a map's spatial spread is a few steps; bf16
# against f32 costs 2.4e-4 at the float level, [numerics])
UINT8_PEARSON_SLACK = 5e-3


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def write_npy_table(path: Path, rows) -> str:
    """A dataframe CSV of ``rows`` (dicts of one set of keys)."""
    import csv

    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return str(path)


def consumer_phases(tmp: Path, ckpt: Path, enc: Path, tiles: np.ndarray, cpu32: np.ndarray,
                    pred_bf16: np.ndarray, depth: int):
    """The port's copies of the five scripts outside the JAX package that
    run a model, each through its CLI ``main`` on the card at full width on
    synthetic data, one output of each checked against the CPU's f32 run:

    - [embeddings]: ``extract_embeddings`` over 64 tiles (center-cropped to
      224 px, ViT-g/14 H-Optimus-0 in bf16, two batches: K1 and K2 2 x 40);
      tile 0's class token against the f32 encoder on the CPU (cosine);
    - [embedding map]: ``datasets_umap`` over 8 tiles a split at 224 px
      (the encoder in f32 on the card: K1 and K2 3 x 40); the first train
      tile's class token against the CPU's; ``reduce_2d`` and
      ``plot_embedding`` only where umap-learn or scikit-learn and
      matplotlib are installed (the phase names the steps it ran);
    - [roi]: ``roi_inference`` on tile 0 through the flagship (its
      checkpoint and encoder files, a config.yaml and a logreg.npz; K1, K2
      40, K3 1): the written mIF (uint8) against the CPU's f32 prediction
      of that tile (``cpu32``: per-marker Pearson within
      ``UINT8_PEARSON_SLACK`` of the CPU's own uint8 of it; the steps from
      the card's own bf16 prediction of it in a batch of 64, ``pred_bf16``,
      printed), the cell table's means against the CPU prediction pooled
      over the same nuclei;
    - [panels]: ``prediction_panels`` on 2 test tiles (K1, K2 80, K3 2):
      tile 0's prediction, as [roi]'s; the PNGs where matplotlib is
      installed;
    - [inference hemit]: ``inference_hemit`` over 8 HEMIT pairs through the
      ConvNeXt-L U-Net (``synth_value`` weights, heads through
      ``contrast_head``, bf16 compute; no kernel): tile 0's ``_fake_B``
      against the CPU's f32 run of the same checkpoint (Pearson, as
      [roi]'s).

    Writes no generator snapshot (the U-Net's checkpoint in f16, 0.4 GB).
    Returns each path's launch counts."""
    import importlib.util

    import cv2

    from mipheivit_tpu_torch.config import save_config
    from mipheivit_tpu_torch.data.stats import HOPTIMUS_MEAN, HOPTIMUS_STD
    from mipheivit_tpu_torch.data.table import Table
    from mipheivit_tpu_torch.examples import roi_inference
    from mipheivit_tpu_torch.figures import datasets_umap, prediction_panels
    from mipheivit_tpu_torch.infer.loading import load_state_dict, load_vit_encoder
    from mipheivit_tpu_torch.infer.tiles import predictions_to_uint8
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.metrics.cell import CellMetrics
    from mipheivit_tpu_torch.models.foundation import get_encoder_spec
    from mipheivit_tpu_torch.preprocessings.artifacts_detection import extract_embeddings
    from mipheivit_tpu_torch.preprocessings.nuclei_segmentation.backends import get_backend
    from mipheivit_tpu_torch.scripts import inference_hemit
    from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid

    root = tmp / "consumers"
    root.mkdir()
    counts = {}
    crops = tiles[:CONSUMER_TILES, 16:240, 16:240]          # 256 -> 224, as the CLI crops
    rows = []
    for i, t in enumerate(tiles[:CONSUMER_TILES]):
        np.save(root / f"t{i}.npy", t)
        rows.append({"image_path": str(root / f"t{i}.npy")})
    t0 = time.perf_counter()
    cpu_enc = load_vit_encoder(get_encoder_spec("hoptimus0", 224).vit_cfg,
                               load_state_dict(enc), "cpu")

    def cpu_cls(crop):
        x = (crop.astype(np.float32) - HOPTIMUS_MEAN) / HOPTIMUS_STD
        with torch.inference_mode():
            return cpu_enc(torch.from_numpy(x[None]))[0, 0].numpy()

    # [embeddings]
    reset_counts()
    extract_embeddings.main(["--tile_dataframe", write_npy_table(root / "tiles.csv", rows),
                             "--out_dir", str(root / "emb"), "--encoder_weights", str(enc),
                             "--img_size", "224", "--batch_size", "32",
                             "--shard_size", str(CONSUMER_TILES)])
    torch.cuda.synchronize()
    counts["embeddings"] = read_counts()
    emb = np.load(root / "emb" / "embeddings_0000.npy")
    names = (root / "emb" / "names_0000.csv").read_text().split()
    cos = cosine(emb[0], cpu_cls(crops[0]))
    print(f"[embeddings] extract_embeddings: {emb.shape} {emb.dtype} embeddings, "
          f"{len(names) - 1} names; tile 0's class token (bf16 card) vs f32 CPU cosine "
          f"{cos:.6f} (target >= {MIN_PEARSON}); {counts_line(counts['embeddings'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(emb.shape == (CONSUMER_TILES, HD) and emb.dtype == np.float16
          and bool(np.isfinite(emb).all()), "[embeddings] output")
    check(names == ["0"] + [f"t{i}" for i in range(CONSUMER_TILES)], "[embeddings] names")
    check(cos >= MIN_PEARSON, "[embeddings] the class tokens do not track the CPU's")
    n_b = -(-CONSUMER_TILES // 32)
    check_counts("[embeddings]", counts["embeddings"], k1=depth * n_b, k2=depth * n_b)

    # [embedding map]
    t0 = time.perf_counter()
    split_csv = {}
    for s_i, split in enumerate(("train", "val", "test")):
        split_rows = []
        for j in range(CONSUMER_MAP_TILES):
            i = s_i * CONSUMER_MAP_TILES + j
            np.save(root / f"m{i}.npy", crops[i])
            split_rows.append({"image_path": str(root / f"m{i}.npy")})
        split_csv[split] = write_npy_table(root / f"{split}.csv", split_rows)
    have = {m: importlib.util.find_spec(m) is not None for m in ("umap", "sklearn", "matplotlib")}
    reducer = have["umap"] or have["sklearn"]
    args = ["--train_csv", split_csv["train"], "--val_csv", split_csv["val"],
            "--test_csv", split_csv["test"], "--out_path", str(root / "map.png"),
            "--encoder_ckpt", str(enc), "--n_per_split", str(CONSUMER_MAP_TILES), "--seed", "0",
            "--device", "cuda"]
    seen = {}
    reset_counts()
    if reducer and have["matplotlib"]:
        real = datasets_umap.reduce_2d
        datasets_umap.reduce_2d = lambda e, seed=0: (seen.setdefault("embs", e), real(e, seed))[1]
        try:
            datasets_umap.main(args)
        finally:
            datasets_umap.reduce_2d = real
        ran = "main: sample_splits, build_encoder, embed_splits, reduce_2d, plot_embedding"
    else:
        dfs = datasets_umap.sample_splits(split_csv["train"], split_csv["val"],
                                          split_csv["test"], CONSUMER_MAP_TILES, 0)
        apply, norm = datasets_umap.build_encoder("hoptimus0", 224, str(enc), 0, "cuda")
        seen["embs"], _ = datasets_umap.embed_splits(dfs, apply, norm)
        ran, skipped = "sample_splits, build_encoder, embed_splits", []
        if reducer:
            datasets_umap.reduce_2d(seen["embs"], 0)
            ran += ", reduce_2d"
        else:
            skipped.append("reduce_2d (neither umap-learn nor scikit-learn is installed)")
        skipped.append("plot_embedding (" + ("no matplotlib" if not have["matplotlib"]
                                             else "no 2-D coordinates") + ")")
        ran += f"; not run: {', '.join(skipped)}"
    torch.cuda.synchronize()
    counts["embedding map"] = read_counts()
    first = datasets_umap.sample_splits(split_csv["train"], split_csv["val"], split_csv["test"],
                                        CONSUMER_MAP_TILES, 0)["train"].row(0)["image_path"]
    want = cpu_cls(np.load(first))
    got = seen["embs"][0]
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"[embedding map] datasets_umap ({ran}): {seen['embs'].shape} f32 class tokens; "
          f"{Path(first).name}'s (f32 card) vs f32 CPU max |err| {err:.2e} of max|ref| "
          f"(target <= {F32_CARD_VS_CPU_TOL:g}); {counts_line(counts['embedding map'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(seen["embs"].shape == (3 * CONSUMER_MAP_TILES, HD), "[embedding map] output")
    check(err <= F32_CARD_VS_CPU_TOL, "[embedding map] the f32 class tokens differ from the CPU's")
    n_b = -(-CONSUMER_MAP_TILES // 16) * 3
    check_counts("[embedding map]", counts["embedding map"], k1=depth * n_b, k2=depth * n_b)
    if have["matplotlib"] and reducer:
        check((root / "map.png").exists(), "[embedding map] no PNG")
    del cpu_enc

    # [roi] and [panels]: a checkpoint dir of the flagship's files
    t0 = time.perf_counter()
    run_dir = root / "run"
    run_dir.mkdir()
    (run_dir / "model.safetensors").symlink_to(ckpt / "model.safetensors")
    names = FLAGSHIP_PRESET["data"]["targ_channel_names"]
    stats = {"RGB": {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]},
             **{m: {"idx_channel": i, "std": 30.0, "min": 0} for i, m in enumerate(names)}}
    (root / "channel_stats.json").write_text(json.dumps(stats))
    test_rows = []
    for i in range(2):
        target = root / f"target{i}.tiff"
        write_pyramid(str(target), np.moveaxis(predictions_to_uint8(cpu32[0]), -1, 0)
                      if i == 0 else np.zeros((MARKERS, IMG, IMG), np.uint8), n_levels=1,
                      tile_size=IMG)
        test_rows.append({"image_path": rows[i]["image_path"], "target_path": str(target)})
    save_config(trainer_config({"model.encoder.encoder_weights": str(enc),
                                "data.channel_stats_path": str(root / "channel_stats.json"),
                                "data.test_dataframe_path": write_npy_table(root / "test_df.csv",
                                                                            test_rows)}),
                run_dir / "config.yaml")
    n_gate = len(CellMetrics(roi_slide_table(), names).marker_names)
    rng = np.random.default_rng(SEED + 300)
    np.savez(run_dir / "logreg.npz", weight=rng.standard_normal((n_gate, n_gate)).astype(
        np.float32) * 0.05, bias=np.zeros(n_gate, np.float32))
    ref_u8 = predictions_to_uint8(cpu32[0])
    card_u8 = predictions_to_uint8(pred_bf16[0]).astype(np.int32)

    own = pearson(ref_u8.astype(np.float32), cpu32[0])

    def against_refs(u8):
        """(per-marker Pearson against cpu32 less the CPU's own uint8's,
        max |step| from the card's batched bf16 prediction)."""
        return (pearson(u8.astype(np.float32), cpu32[0]) - own,
                int(np.abs(u8.astype(np.int32) - card_u8).max()))

    reset_counts()
    roi_inference.main(["--checkpoint_dir", str(run_dir), "--input", rows[0]["image_path"],
                        "--size", str(IMG), "--out_prefix", str(root / "roi"), "--device", "cuda"])
    torch.cuda.synchronize()
    counts["roi"] = read_counts()
    ts = TiffSlide(str(root / "roi_mif.ome.tiff"))
    mif = ts.read_region((0, 0), 0, (IMG, IMG))
    ts.close()
    r, steps = against_refs(mif)
    cells = Table.read_csv(str(root / "roi_cells.csv"))
    labels = get_backend("auto")(mif[..., 0])
    cm = CellMetrics(roi_slide_table(), names, min_area=20)
    cm.update(torch.from_numpy(cpu32), torch.from_numpy(np.asarray(labels))[None], ["roi"])
    want = cm.get_dataframe_cell_pred()
    pred_cols = cm.marker_pred_cols
    same_cells = list(cells["cell_id"]) == list(want["cell_id"])
    got_m = np.stack([np.asarray(cells[c], np.float64) for c in pred_cols], 1)
    want_m = np.stack([np.asarray(want[c], np.float64) for c in pred_cols], 1)
    mean_r = cosine(got_m - got_m.mean(), want_m - want_m.mean()) if len(want) > 1 else 1.0
    print(f"[roi] roi_inference at {IMG} px: mIF {mif.shape} vs the CPU's f32 prediction: "
          f"per-marker Pearson {r.min():+.2e} at worst from that of the CPU's own uint8 (min "
          f"{own.min():.5f}; target >= -{UINT8_PEARSON_SLACK:g}), max {steps} step(s) "
          f"from the card's batched bf16 prediction; {len(cells)} cells "
          f"(the CPU prediction over the same nuclei: same cells {same_cells}, marker means' "
          f"correlation {mean_r:.5f}, target >= {MIN_PEARSON}), logreg columns "
          f"{sum(c.endswith('_logreg') for c in cells.columns)}; "
          f"{counts_line(counts['roi'])} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(bool((r >= -UINT8_PEARSON_SLACK).all()),
          "[roi] the mIF does not track the CPU's prediction")
    check(same_cells and mean_r >= MIN_PEARSON, "[roi] the cell table differs from the CPU's")
    check_counts("[roi]", counts["roi"], k1=depth, k2=depth, k3=1)

    t0 = time.perf_counter()
    drawn = []
    reset_counts()
    if have["matplotlib"]:
        real = prediction_panels.render_panel
        prediction_panels.render_panel = lambda he, gt, pred, nm, out: (
            drawn.append((he, gt, pred)), real(he, gt, pred, nm, out))
        try:
            prediction_panels.main(["--checkpoint_dir", str(run_dir), "--out_dir",
                                    str(root / "panels"), "--n_tiles", "2", "--device", "cuda"])
        finally:
            prediction_panels.render_panel = real
        ran = "main: predict_panels, render_panel"
    else:
        drawn = prediction_panels.predict_panels(str(run_dir), 2, 0, "cuda")[1]
        ran = "predict_panels; not run: render_panel (no matplotlib)"
    torch.cuda.synchronize()
    counts["panels"] = read_counts()
    mine = [d for d in drawn if np.array_equal(d[0], tiles[0])]
    r, steps = against_refs(mine[0][2]) if mine else (np.full(1, -1.0), -1)
    print(f"[panels] prediction_panels ({ran}): {len(drawn)} panels; tile 0's prediction vs the "
          f"CPU's f32: per-marker Pearson {r.min():+.2e} at worst from that of the CPU's own "
          f"uint8 (target >= -{UINT8_PEARSON_SLACK:g}), max "
          f"{steps} step(s) from the card's batched bf16 prediction; "
          f"{counts_line(counts['panels'])} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(len(drawn) == 2 and len(mine) == 1 and bool((r >= -UINT8_PEARSON_SLACK).all()),
          "[panels] the prediction does not track the CPU's")
    check(np.array_equal(mine[0][1], ref_u8), "[panels] the target read back differs")
    if have["matplotlib"]:
        check(sorted(p.name for p in (root / "panels").iterdir()) == ["panel_0.png",
                                                                      "panel_1.png"],
              "[panels] PNGs")
    check_counts("[panels]", counts["panels"], k1=2 * depth, k2=2 * depth, k3=2)

    # [inference hemit]
    t0 = time.perf_counter()
    from mipheivit_tpu_torch.models.smp_unet import UnetMultiHeads

    unet = contrast_heads(seeded_fill(UnetMultiHeads(encoder_name="convnext", out_chans=1),
                                      SEED + 310)).half()
    save_file({f"generator.{k}": v.numpy() for k, v in unet.state_dict().items()},
              root / "unet.safetensors")
    del unet
    rng = np.random.default_rng(SEED + 311)
    for sub in ("input", "label"):
        (root / "hemit" / "test" / sub).mkdir(parents=True)
    for i in range(CONSUMER_HEMIT_TILES):
        for sub in ("input", "label"):
            cv2.imwrite(str(root / "hemit" / "test" / sub / f"p{i}.png"),
                        tiles[i] if sub == "input" else rng.integers(0, 256, (IMG, IMG, 3),
                                                                     dtype=np.uint8))
    reset_counts()
    inference_hemit.main(["--dataset_dir", str(root / "hemit"), "--checkpoint_path",
                          str(root / "unet.safetensors"), "--output_dir", str(root / "hemit_out"),
                          "--batch_size", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    counts["inference hemit"] = read_counts()
    fake = cv2.imread(str(root / "hemit_out" / "images" / "0_fake_B.png"), cv2.IMREAD_UNCHANGED)
    cpu_unet = inference_hemit.load_model(str(root / "unet.safetensors"), "convnext", "cpu")
    norm = inference_hemit.Normalizer({"mean": [127.5] * 3, "std": [127.5] * 3}, mode="he")
    bgr = cv2.imread(str(root / "hemit" / "test" / "input" / "p0.png"))[..., ::-1]
    with torch.inference_mode():
        out = cpu_unet(torch.from_numpy(np.ascontiguousarray(norm(bgr[None].astype(np.float32)))))
    want_f = np.clip((out.numpy()[0] + 0.9) * 255.0 / 1.8, 0.0, 255.0)
    want = want_f[..., 0].astype(np.uint8)
    diff = np.abs(fake.astype(np.int32) - want.astype(np.int32))
    own = pearson(want[..., None].astype(np.float32), want_f)
    r = pearson(fake[..., None].astype(np.float32), want_f) - own
    n_out = len(list((root / "hemit_out" / "images").iterdir()))
    print(f"[inference hemit] inference_hemit over {CONSUMER_HEMIT_TILES} pairs: {n_out} PNGs; "
          f"tile 0's _fake_B (bf16 card) vs f32 CPU: Pearson {r.min():+.2e} from that of the "
          f"CPU's own uint8 ({own.min():.5f}; target >= -{UINT8_PEARSON_SLACK:g}), max |diff| "
          f"{diff.max()} steps, mean {diff.mean():.3f}; output "
          f"std {want.std():.2f} steps; {counts_line(counts['inference hemit'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(n_out == 3 * CONSUMER_HEMIT_TILES and fake.shape == (IMG, IMG), "[inference hemit] PNGs")
    check(bool((r >= -UINT8_PEARSON_SLACK).all()),
          "[inference hemit] _fake_B does not track the CPU's")
    check_counts("[inference hemit]", counts["inference hemit"])
    torch.cuda.empty_cache()
    return counts


def roi_slide_table():
    """roi_inference's one-slide dataframe."""
    from mipheivit_tpu_torch.data.table import Table

    return Table({"in_slide_name": ["roi"], "nuclei_csv_path": [None]})


def main() -> None:
    # 1. device
    check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| cards {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    from mipheivit_tpu_torch import _build
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE, predict_tiles
    from mipheivit_tpu_torch.ops import attention as attn

    # 2. build the kernels from the sources in the checkout, one nvcc per
    #    source, at once: K1 and K6 (attention.cu), K4, K5, K2 and K7
    #    (swiglu.cu), K3, K8
    t0 = time.perf_counter()
    kernels = ("attention", "flash_attention", "flash_attention_bwd", "swiglu", "seg_heads",
               "attn_block")
    with ThreadPoolExecutor(len(kernels)) as pool:
        libs = list(pool.map(_build.build, kernels))
    root = Path(__file__).resolve().parent
    print(f"[build] {', '.join(str(lib.relative_to(root)) for lib in libs)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. K1 against the plain version on the card, at the flagship shapes
    rng = np.random.default_rng(SEED)
    hd = 24 * 64
    big = torch.from_numpy(rng.standard_normal((BATCH, 329, 3 * hd), dtype=np.float32)
                           ).to(dev, torch.bfloat16)
    small = torch.from_numpy(rng.standard_normal((2, 329, 3 * hd), dtype=np.float32)).to(dev)
    cases = {
        "bf16_fused": ("bf16", (big[..., :hd], big[..., hd:2 * hd], big[..., 2 * hd:])),
        # LoRA-live layout: q a fresh tensor, k and v strided views of qkv
        "bf16_split": ("bf16", (big[..., :hd].clone(), big[..., hd:2 * hd], big[..., 2 * hd:])),
        "f32_fused": ("f32", (small[..., :hd], small[..., hd:2 * hd], small[..., 2 * hd:])),
    }
    kernel_rows = {}
    with torch.inference_mode():
        for name, (kind_dt, (q, k, v)) in cases.items():
            got = attn.attention_bshd(q, k, v, 24)
            want = attn.attention_reference(q, k, v, 24)
            torch.cuda.synchronize()
            err, rel, fro = scaled_err(got, want)
            ms = cuda_ms(lambda: attn.attention_bshd(q, k, v, 24))
            plain_ms = cuda_ms(lambda: attn.attention_reference(q, k, v, 24))
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                heads_view(q), heads_view(k), heads_view(v)))
            b_, s_, _ = q.shape
            bnd, by = bound_ms(4 * b_ * s_ * hd * q.element_size(),
                               4.0 * b_ * HEADS * s_ * s_ * 64, kind_dt)
            kernel_rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}
            print(f"[k1 {name}] shape {tuple(q.shape)} max_abs_err {err:.3e} = {rel:.2e} of "
                  f"max|ref|, norm-rel {fro:.2e} (tol {SCALED_TOL[kind_dt][0]:g}, "
                  f"{SCALED_TOL[kind_dt][1]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                  f"library {library_ms:.3f} ms bound {bnd:.3f} ms ({by})", flush=True)
            check(rel <= SCALED_TOL[kind_dt][0] and fro <= SCALED_TOL[kind_dt][1],
                  f"K1 {name} disagrees with the plain version")
    del big, small, cases
    # K1 at one rank's heads of [tp forward]'s tile batch, and at the
    # ablation encoders' shapes at batch 64 (univ2: 8 registers, S 333)
    k1_tp = k1_fused_phase("bf16_tp", TP_TILES, 329, HEADS // PAR_RANKS, SEED + 65)
    k1_encoders = {}
    for i, name in enumerate(ABLATION_ENCODERS):
        s_, _, heads, _ = ENCODER_GEOMETRY[name]
        k1_encoders[name] = k1_fused_phase(f"bf16_{name}", BATCH, s_, heads, SEED + 66 + i)

    # 3b. K4 against the plain version: a 1024-px region (fused qkv layout),
    #     a sequence shard's rectangle, f32, and ragged lengths
    def fused(b, s, dtype, seed, hd=HD):
        t = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (b, s, 3 * hd), dtype=np.float32)).to(dev, dtype)
        return t[..., :hd], t[..., hd:2 * hd], t[..., 2 * hd:]

    # (S = 5334 = 41 x 128 + 86: the last q tile and the last key tile ragged)
    q, k, v = fused(2, REGION_S, torch.bfloat16, SEED + 10)
    k4_region = k4_phase("bf16_region", q, k, v)
    k4_phase("bf16_cross", q[:, :1334], k, v)
    # the same rectangle over keys padded to 5376 of which 5334 are live,
    # the padding NaN (keys) and Inf (values)
    _, kp, vp = fused(2, 5376, torch.bfloat16, SEED + 11)
    kp[:, :REGION_S], vp[:, :REGION_S] = k, v
    kp[:, REGION_S:], vp[:, REGION_S:] = float("nan"), float("inf")
    k4_phase("bf16_cross_padded_nan", q[:, :1334], kp, vp, REGION_S)
    # the sequence-sharded paths' rectangles: a 1024-px region's query shard
    # at 2 ranks (2667 x 5334), and a 2048-px region's (21 321 tokens
    # padded to 21 322: 10 661 query rows over 21 322 keys, the one padding
    # key NaN and its value Inf, masked by seq_len_k)
    seq_rows = -(-REGION_S // PAR_RANKS)
    k4_phase("bf16_seq_shard_1024", q[:1, :seq_rows], k[:1], v[:1])
    del q, k, v, kp, vp
    s2048 = SEQ_TOKENS + (-SEQ_TOKENS) % PAR_RANKS
    q, k, v = fused(1, s2048, torch.bfloat16, SEED + 15)
    k[:, SEQ_TOKENS:], v[:, SEQ_TOKENS:] = float("nan"), float("inf")
    k4_phase("bf16_seq_shard_2048", q[:, :s2048 // PAR_RANKS], k, v, SEQ_TOKENS)
    del q, k, v
    k4_phase("f32", *fused(1, 1029, torch.float32, SEED + 12))
    for s_ in (513, 1301, 2049):
        k4_phase(f"ragged_{s_}", *fused(2, s_, torch.bfloat16, SEED + s_))
    torch.cuda.empty_cache()

    # 3c. K5 against the plain version: a 1024-px region (the backward of
    #     region training), ragged lengths, a rectangle over padded keys, f32
    q, k, v = fused(1, REGION_S, torch.bfloat16, SEED + 20)
    k5_region = k5_phase("bf16_region", q, k, v, seed=SEED + 21)
    for s_ in (513, 1301, 2049):
        k5_phase(f"ragged_{s_}", *fused(2, s_, torch.bfloat16, SEED + 30 + s_), seed=s_)
    _, kp, vp = fused(1, 5376, torch.bfloat16, SEED + 22)
    kp[:, :REGION_S], vp[:, :REGION_S] = k, v
    k5_phase("bf16_cross_padded", q[:, :1334], kp, vp, REGION_S, seed=SEED + 23)
    # the backward of [train seq shard 1024]'s query shard
    k5_phase("bf16_seq_shard_1024", q[:, :-(-REGION_S // PAR_RANKS)], k, v, seed=SEED + 26)
    del q, k, v, kp, vp
    k5_phase("f32", *fused(1, 1029, torch.float32, SEED + 24), seed=SEED + 25)
    # K4 and K5 at [tp train 1024]'s shape: one rank's 12 heads of a 1024-px
    # region ([tp int8 forward]'s region runs K4 there too)
    q, k, v = fused(1, REGION_S, torch.bfloat16, SEED + 27, hd=HD // PAR_RANKS)
    k4_tp = k4_phase("bf16_tp_region", q, k, v, heads=HEADS // PAR_RANKS)
    k5_tp = k5_phase("bf16_tp_region", q, k, v, seed=SEED + 28, heads=HEADS // PAR_RANKS)
    del q, k, v
    torch.cuda.empty_cache()

    # 3d. K2 against the plain version at every path's fc1: a batch of 64
    #     tiles (M = 64 x 329), the daemon's batch of 32, 4 regions (4 x
    #     5334), a 256-px training microbatch (8 x 329) and a 1024-px one
    #     (5334); ragged M, one row, H and K tails, f32, and the LayerNorm
    #     variant (not on a path); then K2's backward terms at the two
    #     training microbatches and f32
    k2_flagship = k2_phase("bf16_tiles", BATCH * 329, torch.bfloat16, seed=SEED + 40)
    k2_phase("bf16_serve", SERVE_BATCH * 329, torch.bfloat16, seed=SEED + 46)
    k2_phase("bf16_regions", 4 * REGION_S, torch.bfloat16, seed=SEED + 41)
    k2_phase("bf16_train256", MICRO * 329, torch.bfloat16, seed=SEED + 47)
    k2_phase("bf16_train1024", REGION_MICRO * REGION_S, torch.bfloat16, seed=SEED + 48)
    k2_phase("bf16_ragged", 658, torch.bfloat16, seed=SEED + 42)
    k2_phase("bf16_one_row", 1, torch.bfloat16, seed=SEED + 49)
    k2_phase("bf16_tails", 330, torch.bfloat16, seed=SEED + 63, k=200, h=520)
    # one rank's half of the SwiGLU hidden width at [tp forward]'s tile batch
    k2_tp = k2_phase("bf16_tp", TP_TILES * 329, torch.bfloat16, seed=SEED + 64,
                     h=FC1_H // PAR_RANKS)
    k2_phase("f32", 658, torch.float32, seed=SEED + 43)
    k2_phase("bf16_ln", BATCH * 329, torch.bfloat16, ln=True, seed=SEED + 44)
    k2_phase("f32_ln", 658, torch.float32, ln=True, seed=SEED + 45)
    k2b_flagship = k2b_phase("bf16_train1024", REGION_MICRO * REGION_S, torch.bfloat16,
                             seed=SEED + 60)
    k2b_phase("bf16_train256", MICRO * 329, torch.bfloat16, seed=SEED + 61)
    k2b_phase("f32", 658, torch.float32, seed=SEED + 62)
    torch.cuda.empty_cache()

    # 3e. K3 against the plain version: the decoder's last map of a batch of
    #     64 tiles, of the daemon's batch of 32, of 4 regions, f32, a smaller
    #     odd batch, and a 19-marker panel (three groups of 8 heads in one
    #     pass of 24; its rows of 38-byte pixels leave by 16-byte stores)
    k3_flagship = k3_phase("bf16_tiles", BATCH, IMG, IMG, torch.bfloat16, seed=SEED + 50)
    k3_phase("bf16_serve", SERVE_BATCH, IMG, IMG, torch.bfloat16, seed=SEED + 54)
    k3_phase("bf16_regions", 4, REGION, REGION, torch.bfloat16, seed=SEED + 51)
    k3_phase("f32", 2, IMG, IMG, torch.float32, seed=SEED + 52)
    k3_phase("bf16_small", 3, 128, 128, torch.bfloat16, seed=SEED + 53)
    k3_phase("bf16_panel19", 8, IMG, IMG, torch.bfloat16, seed=SEED + 55, k=19)
    torch.cuda.empty_cache()

    # 3f. K6, K7 and K8 against their plain versions at the JAX package's
    #     profiling shapes (dot_product_attention [64, 24, 329, 64]; ViT-g's
    #     qkv projection and attention sublayer at 64 tiles), ragged and
    #     longer lengths, f32; dot_product_attention above 512 tokens is K4's
    k6_flagship = k6_phase("bf16", BATCH, 329, torch.bfloat16, seed=SEED + 70)
    k6_phase("bf16_ragged_77", BATCH, 77, torch.bfloat16, seed=SEED + 73)
    k6_phase("f32", 2, 329, torch.float32, seed=SEED + 76)
    k6_long_check()
    k7_flagship = k7_phase("bf16", BATCH * 329, torch.bfloat16, seed=SEED + 100)
    k7_phase("bf16_ragged_658", 658, torch.bfloat16, seed=SEED + 104)
    k7_phase("f32_658", 658, torch.float32, seed=SEED + 108)
    k8_flagship = k8_phase("bf16", BATCH, 329, torch.bfloat16, seed=SEED + 110)
    k8_phase("bf16_1024", 4, 1024, torch.bfloat16, seed=SEED + 114)
    k8_phase("f32", 2, 329, torch.float32, seed=SEED + 118)
    torch.cuda.empty_cache()

    # 3g. head dims below 64 through the attention kernels, K7 and K2 off
    #     their kernels' widths (zero-padded), head dims 80 and 128 through
    #     K4's and K5's 128-wide instances, K3 at 16, 48 and 64 channels,
    #     ln_qkv_attention's routes beyond ViT-g's shape; what no kernel
    #     takes raises on the card, before any launch
    head_dims_phase()
    wide = wide_heads_phase()
    k3_widths = k3_widths_phase()
    ln_qkv_routes_phase()
    rejects_phase()

    # 3h. per-nucleus pooling and the cell loss (plain PyTorch on the card:
    #     XLA in the JAX package, no Pallas kernel to port)
    with tempfile.TemporaryDirectory() as tmp:
        pool_ms, cell_loss_ms = segment_pool_phase(dev, Path(tmp))
    torch.cuda.empty_cache()

    # 3i. int8 W8A8 serving's ops (torch._int_mm, a library call, and PyTorch
    #     passes: XLA ops in the JAX package) against their plain versions
    #     on the CPU, at the flagship's GEMMs and fusion convs of 64 tiles
    int8_ops_phase(dev)
    torch.cuda.empty_cache()

    # 4. the slice at full width
    tiles = np.random.default_rng(SEED + 1).integers(0, 256, (N_TILES, IMG, IMG, 3),
                                                    dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt, enc, n_params = write_checkpoint(Path(tmp), SEED)
        print(f"[checkpoint] {n_params / 1e9:.3f} B synthetic params written "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        model = load(ckpt, enc, dev, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"[load] load_generator + merge_lora + cast_params(bf16) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        reset_counts()
        t0 = time.perf_counter()
        out = predict_tiles(model, tiles, HOPTIMUS_HE, BATCH, dev)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        slice_counts = read_counts()
        depth = model.vit_cfg.depth
        n_batches = -(-N_TILES // BATCH)
        print(f"[slice] predict_tiles {out.shape} {out.dtype} in {e2e_s:.2f} s "
              f"(first call, includes warm-up); {counts_line(slice_counts)} "
              f"({depth} blocks x {n_batches} batches)", flush=True)
        check(out.shape == (N_TILES, IMG, IMG, MARKERS), f"output shape {out.shape}")
        check(out.dtype == np.uint8, f"output dtype {out.dtype}")
        check_counts("[slice]", slice_counts, k1=depth * n_batches, k2=depth * n_batches,
                     k3=n_batches)

        mean = torch.as_tensor(HOPTIMUS_HE.mean, device=dev)
        std = torch.as_tensor(HOPTIMUS_HE.std, device=dev)
        x = (torch.from_numpy(tiles[:BATCH]).to(dev).float() - mean) / std
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            pred_bf16 = model(x)
            torch.cuda.synchronize()
            bf16 = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "weights_gib": model_gib(model)}
            check(bool(torch.isfinite(pred_bf16).all()), "non-finite output in a batch")
            fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
            bf16["ms"] = fwd_ms
        print(f"[throughput] {BATCH * 1000 / fwd_ms:.1f} tiles/s steady bf16 forward "
              f"at batch {BATCH} ({fwd_ms:.2f} ms/batch, CUDA events, median of 10; peak "
              f"{bf16['peak_gib']:.2f} GiB) on {card}", flush=True)
        pred_bf16_batch = pred_bf16.cpu().numpy()
        pred_bf16 = pred_bf16_batch[:1]

        # 4a. block 0's attention sublayer three ways (K1, K7 + K1, K8) on
        #     the loaded generator's weights and the tokens of 64 tiles
        sublayer = attn_sublayer_phase(model, x)

        # 4b. the serving daemon on the same generator
        serve_counts, _ = serve_phase(model, dev)

        # 4c. stitched whole-slide inference at 256-px windows (K1)
        slide = np.random.default_rng(SEED + 2).integers(0, 256, (SLIDE, SLIDE, 3),
                                                         dtype=np.uint8)
        wsi256, wsi256_stats, wsi256_out = wsi_phase("wsi 256", model, slide, IMG, 64, BATCH,
                                                     dev)
        n_wsi = -(-len(range(0, SLIDE - 64, IMG - 64)) ** 2 // BATCH)   # 11 x 11 windows
        check_counts("[wsi 256]", wsi256, k1=depth * n_wsi, k2=depth * n_wsi, k3=n_wsi)

        # 4d. data parallelism in one process: each batch split over two
        #     replicas of the generator (both on the one card)
        wsi_dp = wsi_dp_phase(model, slide, wsi256_out, dev, depth)
        serve_dp = serve_dp_phase(model, tiles, dev, depth)
        del model
        torch.cuda.empty_cache()

        # 4e. int8 W8A8 serving, as run_inference --int8 loads the generator:
        #     the forward (K1, K3; fc1 is an int8 product, so K2 = 0) and the
        #     slide at 256-px windows, each against bf16
        model, throughput_int8 = throughput_int8_phase(Path(tmp), ckpt, enc, x, pred_bf16_batch,
                                                       bf16, dev)
        del pred_bf16_batch
        wsi256_int8 = wsi_int8_phase("wsi 256 int8", model, slide, IMG, 64, BATCH, dev,
                                     wsi256_out, wsi256_stats)
        check_counts("[wsi 256 int8]", wsi256_int8, k1=depth * n_wsi, k3=n_wsi)
        del model, wsi256_out, wsi256_stats
        torch.cuda.empty_cache()

        # 5. full-width numerics: f32 on the card (K1) against f32 on the CPU
        #    (plain attention), one tile
        x1 = x[:1]
        with torch.inference_mode():
            card32 = load(ckpt, enc, dev, torch.float32)(x1).cpu().numpy()
            cpu32 = load(ckpt, enc, "cpu", torch.float32)(x1.cpu()).numpy()
        diff = float(np.abs(card32 - cpu32).max())
        print(f"[numerics] f32 card vs f32 CPU, one tile: max_abs_diff {diff:.3e} "
              f"(target <= {F32_CARD_VS_CPU_TOL:g})", flush=True)
        check(diff <= F32_CARD_VS_CPU_TOL, "f32 card output differs from the CPU")
        r = pearson(pred_bf16, cpu32)
        print(f"[numerics] bf16 card vs f32 CPU per-marker Pearson: min {r.min():.5f} "
              f"(target >= {MIN_PEARSON}) all {np.round(r, 5).tolist()}", flush=True)
        check(bool((r >= MIN_PEARSON).all()), "bf16 output does not track the f32 output")

        # 5b. the port's copies of the five scripts outside the JAX package
        #     that run a model, through their CLIs on the card: [embeddings],
        #     [embedding map], [roi], [panels] (tile 0 against cpu32),
        #     [inference hemit]
        consumer_counts = consumer_phases(Path(tmp), ckpt, enc, tiles, cpu32, pred_bf16, depth)
        torch.cuda.empty_cache()

        # 6. stitched whole-region inference at 1024-px windows (K4): the
        #    generator loaded at 1024 px, its position embedding re-gridded
        t0 = time.perf_counter()
        model = load(ckpt, enc, dev, torch.bfloat16, REGION)
        torch.cuda.synchronize()
        print(f"[load] at {REGION} px: load_generator + merge_lora + cast_params(bf16) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        wsi1024, wsi1024_stats, wsi1024_out = wsi_phase("wsi 1024", model, slide, REGION, 128,
                                                        4, dev)
        n_wsi = -(-len(range(0, SLIDE - 128, REGION - 128)) ** 2 // 4)   # 3 x 3 windows
        check_counts("[wsi 1024]", wsi1024, k4=depth * n_wsi, k2=depth * n_wsi, k3=n_wsi)
        t0 = time.perf_counter()
        xr = (torch.from_numpy(slide[None, :REGION, :REGION]).to(dev).float() - mean) / std
        with torch.inference_mode():
            region_bf16 = model(xr).cpu().numpy()
        region_s = time.perf_counter() - t0

        # 6b. the same generator in int8 W8A8 (K4, K3; K2 = 0), the slide
        #     against the bf16 one
        from mipheivit_tpu_torch.infer import quantize_decoder, quantize_encoder

        quantize_decoder(quantize_encoder(model))
        wsi1024_int8 = wsi_int8_phase("wsi 1024 int8", model, slide, REGION, 128, 4, dev,
                                      wsi1024_out, wsi1024_stats)
        check_counts("[wsi 1024 int8]", wsi1024_int8, k4=depth * n_wsi, k3=n_wsi)
        del model, wsi1024_stats
        torch.cuda.empty_cache()

        # 7. region numerics: bf16 against f32 on the card at full depth, and
        #    f32 on the card (K4) against f32 on the CPU (plain) with the
        #    encoder cut to its first 2 blocks at full width
        t0 = time.perf_counter() - region_s
        with torch.inference_mode():
            model = load(ckpt, enc, dev, torch.float32, REGION)
            region_f32 = model(xr).cpu().numpy()
            model.encoder.vit.blocks = model.encoder.vit.blocks[:2]
            card2 = model(xr).cpu().numpy()
            del model
            torch.cuda.empty_cache()
            model = load(ckpt, enc, "cpu", torch.float32, REGION)
            model.encoder.vit.blocks = model.encoder.vit.blocks[:2]
            cpu2 = model(xr.cpu()).numpy()
            del model
        check(bool(np.isfinite(region_bf16).all() and np.isfinite(region_f32).all()),
              "non-finite output on a region")
        diff = float(np.abs(card2 - cpu2).max())
        r = pearson(region_bf16, region_f32)
        print(f"[numerics region] {REGION} px, {REGION_S} tokens: f32 card vs f32 CPU, "
              f"2 blocks: max_abs_diff {diff:.3e} (target <= {F32_CARD_VS_CPU_TOL:g}); "
              f"bf16 vs f32 card, 40 blocks, per-marker Pearson: min {r.min():.5f} "
              f"(target >= {MIN_PEARSON}) ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(diff <= F32_CARD_VS_CPU_TOL, "f32 region output on the card differs from the CPU")
        check(bool((r >= MIN_PEARSON).all()), "bf16 region output does not track f32")
        torch.cuda.empty_cache()

        # 8. training at 256 px: the flagship's generator step, K1 forward
        t0 = time.perf_counter()
        model = train_model(ckpt, enc, IMG, dev)
        print(f"[load] training generator at {IMG} px (LoRA live, per-head decoder) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        data = train_batches(3 * ACCUM, MICRO, IMG, dev, SEED + 3)
        train256, train256_rate = train_phase("train 256", model, data, 3, dev)
        n_micro = 3 * ACCUM
        check_counts("[train 256]", train256, k1=depth * n_micro, k2=depth * n_micro,
                     k2b=depth * n_micro)
        del model
        torch.cuda.empty_cache()

        # 9. whole-region training at 1024 px, batch 1: K4 forward, K5 backward
        t0 = time.perf_counter()
        model = train_model(ckpt, enc, REGION, dev)
        print(f"[load] training generator at {REGION} px in {time.perf_counter() - t0:.1f} s",
              flush=True)
        region_data = train_batches(2 * ACCUM, REGION_MICRO, REGION, dev, SEED + 4)
        train1024, _ = train_phase("train 1024", model, region_data, 2, dev)
        n_micro = 2 * ACCUM
        check_counts("[train 1024]", train1024, k4=depth * n_micro, k5=depth * n_micro,
                     k2=depth * n_micro, k2b=depth * n_micro)

        # 9b. the same with per-block activation checkpointing: each block's
        #     forward (K4) runs again in the backward, before its K5
        train1024c, _ = train_phase("train 1024 ckpt", model, region_data, 2, dev,
                                    grad_checkpointing=True)
        check_counts("[train 1024 ckpt]", train1024c, k4=2 * depth * n_micro,
                     k5=depth * n_micro, k2=2 * depth * n_micro, k2b=depth * n_micro)
        del model
        torch.cuda.empty_cache()

        # 9c. the backward of dot_product_attention (K6), ln_matmul (K7) and
        #     ln_qkv_attention (K8)
        train_ops = train_ops_phase(dev)

        # 10. training numerics: the f32 step on the card against the CPU with
        #     the encoder cut to 2 blocks at full width (256 px: K1 and the plain
        #     recompute; 1024 px: K4 and K5), and bf16 against f32 at full depth
        t0 = time.perf_counter()
        lines, f32_ok, bf16_ok = [], True, True
        for img, batch in ((IMG, {k: v[:2] for k, v in data[0].items()}), (REGION, region_data[0])):
            card_res = one_step_grads(train_model(ckpt, enc, img, dev, depth=2), batch, dev)
            torch.cuda.empty_cache()
            cpu_res = one_step_grads(train_model(ckpt, enc, img, "cpu", depth=2),
                                     {k: v.cpu() for k, v in batch.items()}, "cpu")
            loss_rel, grad_rel = compare_grads(card_res, cpu_res)
            lines.append(f"f32 card vs f32 CPU at 2 blocks, {img} px: loss {card_res[0]:.6f} vs "
                         f"{cpu_res[0]:.6f} (rel {loss_rel:.2e}, tol {TRAIN_LOSS_RTOL:g}), worst "
                         f"LoRA/decoder grad norm-rel {grad_rel:.2e} (tol {TRAIN_GRAD_NORM_RTOL:g})")
            f32_ok = f32_ok and loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_NORM_RTOL
        for img, batch in ((IMG, data[0]), (REGION, region_data[0])):
            res = {}
            for dt in (torch.bfloat16, None):
                res[dt] = one_step_grads(train_model(ckpt, enc, img, dev), batch, dev, dt)
                torch.cuda.empty_cache()
            (loss_bf16, _), (loss_f32, _) = res[torch.bfloat16], res[None]
            rel = abs(loss_bf16 - loss_f32) / abs(loss_f32)
            cos, least, worst = lora_cos(res[torch.bfloat16], res[None])
            lines.append(f"bf16 vs f32 at {depth} blocks, {img} px: loss {loss_bf16:.6f} vs "
                         f"{loss_f32:.6f} (rel {rel:.2e}, tol {BF16_LOSS_RTOL:g}), LoRA q/v grad "
                         f"cosine {cos:.6f} (target >= {BF16_LORA_COS}), least one {least:.6f} "
                         f"({worst})")
            bf16_ok = bf16_ok and rel <= BF16_LOSS_RTOL and cos >= BF16_LORA_COS
        plain = plain_k5_grads(train_model(ckpt, enc, REGION, dev), region_data[0], dev)
        torch.cuda.empty_cache()
        cos, least, worst = lora_cos(res[torch.bfloat16], plain)
        lines.append(f"bf16 at {depth} blocks, {REGION} px, K5 vs its plain version: LoRA q/v "
                     f"grad cosine {cos:.7f}, least one {least:.7f} ({worst}; target >= "
                     f"{K5_STEP_LORA_MIN_COS})")
        bf16_ok = bf16_ok and least >= K5_STEP_LORA_MIN_COS
        print(f"[numerics train] {'; '.join(lines)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        check(f32_ok, "the f32 train step on the card differs from the CPU")
        check(bf16_ok, "the bf16 train step does not track f32")

        # 11. the training driver on the flagship preset (1 epoch, then a
        #     resume to 2) and the eval-only driver on its checkpoint dir
        del data, region_data
        torch.cuda.empty_cache()
        trainer_counts, cfg, logdir, trainer_rate, trainer_ref = trainer_phase(
            Path(tmp), ckpt, enc, depth, train256_rate)
        test_driver_counts = test_driver_phase(cfg, logdir, depth)
        torch.cuda.empty_cache()

        # 12. the single-cell path: the flagship preset as it ships (cell
        #     metrics, val_cell_auc) with the cell loss, its eval-only run,
        #     and the ORION / IMMUCAN / HEMIT evaluation scripts on its export
        cell_counts, cell_cfg, cell_dir, cell_data = cell_trainer_phase(Path(tmp), ckpt, enc,
                                                                        depth, trainer_rate)
        cell_test_counts = cell_test_driver_phase(cell_cfg, cell_dir, depth)
        eval_counts = eval_phases(cell_cfg, cell_dir, cell_data, Path(tmp), depth)
        torch.cuda.empty_cache()

        # 13. the baseline generators: the UNETR preset served and trained
        #     (K1, K2), Prov-GigaPath's UNETR, the SMP U-Net on ConvNeXt-L
        #     with its foreground head and the ResNet-50 UNETR (no kernel)
        baseline_counts, baseline = baseline_phases(Path(tmp), enc, tiles, dev)
        torch.cuda.empty_cache()

        # 14. the Swin models: the ctranspath UNETR and the HEMIT generator
        #     served, the HEMIT zoo, both presets trained, the HEMIT
        #     reproduction and the HEMIT-pipeline evaluations (no kernel)
        swin_counts, swin = swin_phases(Path(tmp), dev)
        torch.cuda.empty_cache()

        # 14b. preprocessing: the TIFF engine, Cellpose on the card, DAPI and
        #      H&E nuclei segmentation, the CycleGAN stain normaliser (no
        #      kernel), and the trainer's profiler hook (the [trainer] run)
        prep_counts = preprocessing_phases(Path(tmp), ckpt, enc, trainer_ref["data"], depth, dev)
        torch.cuda.empty_cache()

        # 15. the multi-card paths over 2 ranks spawned on the one card:
        #     [collectives], [seq shard wsi 1024], [seq shard 2048], [train
        #     seq shard 1024] (K4 on the query shard over the gathered keys,
        #     K5 in the backward, K1 = 0), [trainer ddp]
        parallel_counts = parallel_phases(Path(tmp), ckpt, enc, wsi1024_out, trainer_ref["data"],
                                          trainer_ref, depth)

    # 16. summary lines
    k1 = kernel_rows["bf16_fused"]
    paths = {"slice": slice_counts, "attn sublayer": sublayer, "serve": serve_counts,
             "wsi 256": wsi256, "wsi dp": wsi_dp, "serve dp": serve_dp, "wsi 1024": wsi1024,
             "throughput int8": throughput_int8, "wsi 256 int8": wsi256_int8,
             "wsi 1024 int8": wsi1024_int8,
             "train 256": train256,
             "train 1024": train1024, "train 1024 ckpt": train1024c, "train ops": train_ops,
             "trainer": trainer_counts, "test driver": test_driver_counts,
             "cell trainer": cell_counts, "cell test driver": cell_test_counts, **eval_counts,
             **consumer_counts, **baseline_counts, **swin_counts, **prep_counts,
             **parallel_counts}
    print(f"[cell path] nucleus_pool {pool_ms[8]:.3f} ms at 8 tiles, {pool_ms[64]:.3f} ms at 64; "
          f"cell loss forward + backward {cell_loss_ms:.3f} ms at microbatch 8", flush=True)
    print(f"[baselines] {'; '.join(f'{k} {v:.3f}' for k, v in baseline.items())}", flush=True)
    print(f"[swin models] {'; '.join(f'{k} {v:.3f}' for k, v in swin.items())}", flush=True)

    def launches(key):
        by_path = {path: c[key] for path, c in paths.items() if c[key]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "k1_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:563", **k1, "tp": k1_tp, **k1_encoders,
         **launches("attention")},
        {"name": "k4_flash_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:59", **k4_region, "d128": wide["k4"],
         "tp": k4_tp,
         **launches("flash")},
        {"name": "k5_flash_attention_bwd", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:317", **k5_region, "d128": wide["k5"],
         "tp": k5_tp,
         **launches("flash_bwd")},
        {"name": "k2_swiglu", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/swiglu.cu",
         "replaces": "mipheivit_tpu/ops/mlp.py:51", **k2_flagship, "tp": k2_tp,
         **launches("swiglu")},
        {"name": "k2_swiglu_bwd_gate", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/swiglu.cu",
         "replaces": "mipheivit_tpu/ops/mlp.py:159", **k2b_flagship, **launches("swiglu_bwd")},
        {"name": "k3_seg_heads", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/seg_heads.cu",
         "replaces": "mipheivit_tpu/ops/seg_heads.py:38", **k3_flagship,
         **{f"c{c}": row for c, row in k3_widths.items()}, **launches("seg_heads")},
        {"name": "k6_short_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:109", **k6_flagship, **launches("short")},
        {"name": "k7_ln_matmul", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/swiglu.cu",
         "replaces": "mipheivit_tpu/ops/mlp.py:251", **k7_flagship, **launches("ln_matmul")},
        {"name": "k8_attn_block", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/attn_block.cu",
         "replaces": "mipheivit_tpu/ops/attn_block.py:32", **k8_flagship,
         **launches("attn_block")}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
