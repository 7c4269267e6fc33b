"""Smoke run of the PyTorch port (mipheivit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 attention, K4 long-sequence flash
attention, K5 its backward) from mipheivit_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes the paths give it, then
drives the port's paths at full width from a reference-layout MIPHEI-ViT
checkpoint dir (H-Optimus-0 ViT-g/14 encoder, 16 markers, random weights
from a numpy seed). Serving: load_generator(fast_heads=True) -> merge_lora
-> cast_params(bf16):

  [slice]      predict_tiles on 150 uint8 256-px tiles at batch 64 (K1);
  [wsi 256]    wsi_inference over a synthetic 2048 x 2048 slide, 256-px
               windows, overlap 64, batch 64 (121 windows; K1);
  [wsi 1024]   the same with 1024-px region windows, overlap 128, batch 4
               (9 windows, S = 5334 tokens; K4).

Training: load_generator(fast_heads=False) with LoRA live ->
train.create_train_state(frozen encoder stored bf16) -> make_train_step
(weighted MSE, lambda 50; Adam chain with clip 1.0; microbatches of
accumulation 2; the generator step of the flagship preset, gan_train off):

  [train 256]  256-px tiles, microbatch 8, 3 optimizer steps (K1 forward,
               plain recompute backward);
  [train 1024] 1024-px regions, microbatch 1, 2 optimizer steps (K4
               forward, K5 backward);
  [train 1024 ckpt] the same with each encoder block recomputed in the
               backward (K4 launches twice per block and microbatch).

It checks the outputs (the stitched slides against a serial reference
stitch; finite losses, frozen weights bit-identical and trainable ones
moved), that every encoder block went through the kernels of its length,
and the full-width numerics against the CPU and between bf16 and f32. Each
phase prints one line with its seconds; any failure ends the run with a
non-zero exit. The line before the card line holds the kernels' summary;
the last line is the device JSON.

Needs one CUDA card and nvcc; there is no CPU fallback.
"""

from __future__ import annotations

import hashlib
import json
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
# K1's output against the plain version, max |err|
KERNEL_TOL = {"bf16": 2e-2, "f32": 1e-4}
# K4's output and K5's dQ, dK, dV against the plain version, scaled to the
# reference: max |err| / max |ref| and ||err|| / ||ref|| (at a region the
# gradients are ~0.02 in RMS, so an absolute limit would say little); bf16
# rounds p (and dS) for the tensor cores and the output
SCALED_TOL = {"bf16": (2e-2, 1e-2), "f32": (1e-4, 1e-5)}
# K4's lse against the plain version: bf16 inputs, f32 inputs
LSE_TOL = {"bf16": 1e-3, "f32": 1e-5}
F32_CARD_VS_CPU_TOL = 2e-3
MIN_PEARSON = 0.99
SLIDE = 2048                     # synthetic slide side, px
HEADS, HD = 24, 24 * 64          # ViT-g attention
REGION_S = 73 * 73 + 5           # tokens of a 1024-px region window
# the H100's published dense peaks and memory rate (NVIDIA data sheet, SXM,
# 700 W), for the least time a kernel's work could take
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# training: the flagship preset (configs: microbatch 8 x accumulation 2,
# lr_g 2e-4 scaled by sqrt(16), lambda 50, warmup 400)
MICRO, ACCUM, REGION_MICRO = 8, 2, 1
LR_G, TOTAL_ITERS, LAMBDA = 2e-4, 1000, 50.0
# f32 train step, card vs CPU at 2 blocks: loss relative; gradients in norm,
# relative (a ReLU input within f32 rounding of 0 may take the other branch
# on the other device and move every gradient upstream of it, ~2e-3 of the
# norm for one element at test sizes)
TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL = 1e-4, 1e-2
# bf16 against f32 train step at full depth: loss relative, and the cosine
# of the LoRA q/v gradients taken together (they flow back through every
# block's attention: K1 at 256 px, K4 and K5 at 1024 px)
BF16_LOSS_RTOL, BF16_LORA_COS = 1e-3, 0.99
# the bf16 region step through K5 against the same step through K5's plain
# version: the least cosine of any one LoRA q/v tensor's gradients
K5_STEP_LORA_MIN_COS = 0.999


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
    """``[B, S, H*D]`` -> a ``[B, H, S, D]`` view (the library call's layout)."""
    b, s, _ = t.shape
    v = t.detach().view(b, s, HEADS, 64).transpose(1, 2)
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


def k4_phase(name, q, k, v, seq_len_k=None):
    """K4 against its plain version on one input; prints and checks the
    errors and returns (out_err, lse_err, ms, plain_ms)."""
    from mipheivit_tpu_torch.ops import attention as attn

    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    t0 = time.perf_counter()
    with torch.inference_mode():
        out, lse = attn.flash_attention(q, k, v, HEADS, seq_len_k)
        want_out, want_lse = attn.flash_reference(q, k, v, HEADS, seq_len_k)
        torch.cuda.synchronize()
        out_err, out_rel, out_fro = scaled_err(out, want_out)
        lse_err = (lse - want_lse).abs().max().item()
        del out, lse, want_out, want_lse
        ms = cuda_ms(lambda: attn.flash_attention(q, k, v, HEADS, seq_len_k), reps=10)
        plain_ms = cuda_ms(lambda: attn.flash_reference(q, k, v, HEADS, seq_len_k),
                           reps=3, warmup=1)
    print(f"[k4 {name}] q {tuple(q.shape)} k {tuple(k.shape)} seq_len_k "
          f"{seq_len_k or k.shape[1]} out_err {out_err:.3e} = {out_rel:.2e} of max|ref|, "
          f"norm-rel {out_fro:.2e} (tol {SCALED_TOL[dt][0]:g}, {SCALED_TOL[dt][1]:g}) "
          f"lse_err {lse_err:.3e} (tol {LSE_TOL[dt]:g}) kernel {ms:.3f} ms "
          f"plain {plain_ms:.3f} ms ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(out_rel <= SCALED_TOL[dt][0] and out_fro <= SCALED_TOL[dt][1]
          and lse_err <= LSE_TOL[dt], f"K4 {name} disagrees with the plain version")
    return out_err, lse_err, ms, plain_ms


def k5_phase(name, q, k, v, seq_len_k=None, seed=0):
    """K5 against its plain version on K4's output for one input and a
    random output gradient; prints and checks the dq/dk/dv errors and times
    the kernel, the plain version and the library's attention forward plus
    backward on the same (live) keys. Returns the row's numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention as attn

    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    t0 = time.perf_counter()
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        q.shape, dtype=np.float32)).to(q.device, q.dtype)
    with torch.no_grad():
        out, lse = attn.flash_attention(q, k, v, HEADS, seq_len_k)
        got = attn.flash_backward(q, k, v, out, lse, g, HEADS, seq_len_k)
        want = attn.flash_backward_reference(q, k, v, out, lse, g, HEADS, seq_len_k)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        errs = [scaled_err(a, w) for a, w in zip(got, want)]
        del got, want
        ms = cuda_ms(lambda: attn.flash_backward(q, k, v, out, lse, g, HEADS, seq_len_k), reps=10)
        plain_ms = cuda_ms(lambda: attn.flash_backward_reference(q, k, v, out, lse, g, HEADS,
                                                                 seq_len_k), reps=3, warmup=1)
    live = seq_len_k or k.shape[1]
    ql, kl, vl = (heads_view(t, True) for t in (q, k[:, :live], v[:, :live]))
    gl = heads_view(g)

    def library():
        o = F.scaled_dot_product_attention(ql, kl, vl)
        torch.autograd.grad(o, (ql, kl, vl), gl)

    library_ms = cuda_ms(library, reps=10)
    b, sq, hd = q.shape
    n_bytes = 4 * b * (sq + k.shape[1]) * hd * q.element_size() + b * HEADS * sq * 4
    bnd, by = bound_ms(n_bytes, 10.0 * b * HEADS * sq * live * 64, dt)
    print(f"[k5 {name}] q {tuple(q.shape)} k {tuple(k.shape)} seq_len_k {live} "
          f"dq/dk/dv err {'/'.join(f'{e[0]:.3e}' for e in errs)} = "
          f"{'/'.join(f'{e[1]:.2e}' for e in errs)} of max|ref|, norm-rel "
          f"{'/'.join(f'{e[2]:.2e}' for e in errs)} (tol {SCALED_TOL[dt][0]:g}, "
          f"{SCALED_TOL[dt][1]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms library fwd+bwd "
          f"{library_ms:.3f} ms bound {bnd:.3f} ms ({by}) ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(finite and all(e[1] <= SCALED_TOL[dt][0] and e[2] <= SCALED_TOL[dt][1] for e in errs),
          f"K5 {name} disagrees with the plain version")
    return {"max_abs_err": max(e[0] for e in errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd,
            "bound_by": by, "library_ms": library_ms}


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


def train_setup(model, device, frozen_dtype, grad_checkpointing=False):
    from mipheivit_tpu_torch.train import (build_generator_optimizer, create_train_state,
                                           make_train_step, scaled_lr, weighted_mse_loss)
    from mipheivit_tpu_torch.train.losses import marker_weights_from_stds

    opt = build_generator_optimizer(scaled_lr(LR_G, MICRO * ACCUM), TOTAL_ITERS,
                                    grad_accum_steps=ACCUM)
    state = create_train_state(model, opt, freeze_model_name="myvitmatte",
                               frozen_dtype=frozen_dtype, seed=SEED, device=device,
                               grad_checkpointing=grad_checkpointing)
    stds = np.random.default_rng(SEED + 5).uniform(0.1, 0.3, MARKERS)
    loss = weighted_mse_loss(LAMBDA, marker_weights_from_stds(stds))
    return state, make_train_step(model, loss, opt)


def train_phase(name, model, data, n_opt, device, grad_checkpointing=False):
    """Drive the train step over ``n_opt`` optimizer steps of ``ACCUM``
    microbatches with the launch counts at 0; check finite losses, frozen
    weights bit-identical and LoRA and decoder weights moved. Returns the
    launch counts."""
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.ops import attention as attn

    t_all = time.perf_counter()
    state, step = train_setup(model, device, torch.bfloat16, grad_checkpointing)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    train0 = {n: p.detach().clone() for n, p in state.gen_params}
    metrics = PixelMetrics.zeros(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in attn.launch_counts:
        attn.launch_counts[key] = 0
    losses, nans, step_s = [], [], []
    for s in range(n_opt):
        t0 = time.perf_counter()
        for a in range(ACCUM):
            state, metrics, log = step(state, data[s * ACCUM + a], metrics)
            losses.append(log["gen_loss"])
            nans.append(log["nan"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = dict(attn.launch_counts)
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
          f"{peak_gb:.2f} GiB; launches K1 {counts['attention']} K4 {counts['flash']} "
          f"K5 {counts['flash_bwd']}; loss {', '.join(f'{v:.4f}' for v in losses)}; "
          f"psnr {float(out['psnr']):.3f} ssim {float(out['ssim']):.4f}; frozen bit-identical "
          f"{frozen_same}; moved LoRA {lora_moved}/{n_lora} decoder {dec_moved}/{n_dec} "
          f"({time.perf_counter() - t_all:.1f} s)", flush=True)
    check(all(np.isfinite(losses)) and not any(bool(v) for v in nans), f"{name}: non-finite loss")
    check(frozen_same, f"{name}: a frozen weight changed")
    check(lora_moved == n_lora and dec_moved > 0, f"{name}: trainable weights did not move")
    return counts


def one_step_grads(model, batch, device, frozen_dtype=None):
    """Loss and trainable gradients of one microbatch on ``device``: f32, or
    the frozen encoder stored and run in ``frozen_dtype``."""
    from mipheivit_tpu_torch.metrics import PixelMetrics

    state, step = train_setup(model, device, frozen_dtype)
    _, _, log = step(state, batch, PixelMetrics.zeros(device))
    return float(log["gen_loss"]), {n: g.detach().float().cpu() for n, g in log["grads"].items()}


def lora_cos(a, b):
    """Cosine between two runs' LoRA q/v gradients: (all tensors taken
    together, the least of one tensor, that tensor's name)."""
    import torch.nn.functional as F

    names = [n for n in a[1] if ".lora_" in n]
    per = {n: float(F.cosine_similarity(a[1][n].flatten(), b[1][n].flatten(), 0))
           for n in names}
    worst = min(per, key=per.get)
    every = F.cosine_similarity(torch.cat([a[1][n].flatten() for n in names]),
                                torch.cat([b[1][n].flatten() for n in names]), 0)
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


def compare_grads(card, cpu):
    """(loss relative difference, worst norm-relative gradient difference)."""
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    worst = max(float((card[1][n] - g).norm() / max(float(g.norm()), 1e-30))
                for n, g in cpu[1].items() if float(g.norm()) > 1e-6 * g.numel() ** 0.5)
    return loss_rel, worst


def serial_stitch(model, image, tile, overlap, batch, device):
    """The stitched slide without the pipeline: windows in raster order, the
    same batches padded as the pipeline pads them, the forward and the f32
    codec on the card, then the blend window and the port's
    RollingAccumulator on the host, with no threads."""
    from mipheivit_tpu_torch.infer.stitch import RollingAccumulator, blend_window
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE

    h, w = image.shape[:2]
    stride = tile - overlap
    locs = [(x, y) for y in range(0, max(h - overlap, 1), stride)
            for x in range(0, max(w - overlap, 1), stride)]
    out = np.zeros((MARKERS, h, w), np.uint8)
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
    hold the stitched slide against the serial stitch. Returns the counts
    and the pipeline's stats."""
    from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference
    from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE
    from mipheivit_tpu_torch.ops import attention as attn

    names = [f"m{i}" for i in range(MARKERS)]
    out = np.zeros((MARKERS,) + image.shape[:2], np.uint8)
    stats = {}
    t0 = time.perf_counter()
    for key in attn.launch_counts:
        attn.launch_counts[key] = 0
    wsi_inference(model, ArraySlide(image), out, names, HOPTIMUS_HE, tile_size=tile,
                  overlap=overlap, batch_size=batch, tissue_only=False, stats=stats)
    torch.cuda.synchronize()
    counts = dict(attn.launch_counts)
    e2e_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = serial_stitch(model, image, tile, overlap, batch, device)
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
          f"launches K1 {counts['attention']} K4 {counts['flash']}; serial-stitch max diff "
          f"{diff} uint8 step(s) (target <= 1) ({e2e_s:.1f} s + reference "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)
    check(out.shape == (MARKERS,) + image.shape[:2], f"{name} output shape {out.shape}")
    check(diff <= 1, f"{name}: the stitched slide differs from the serial stitch by {diff}")
    return counts, stats


def pearson(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-marker Pearson correlation of two ``[..., C]`` arrays."""
    a = a.reshape(-1, a.shape[-1]).astype(np.float64)
    b = b.reshape(-1, b.shape[-1]).astype(np.float64)
    a, b = a - a.mean(0), b - b.mean(0)
    return (a * b).sum(0) / np.sqrt((a * a).sum(0) * (b * b).sum(0))


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

    # 2. build K1, K4 and K5 from the sources in the checkout, one nvcc each, at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(_build.build, ("attention", "flash_attention",
                                            "flash_attention_bwd")))
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
            err = (got.float() - want.float()).abs().max().item()
            ms = cuda_ms(lambda: attn.attention_bshd(q, k, v, 24))
            plain_ms = cuda_ms(lambda: attn.attention_reference(q, k, v, 24))
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                heads_view(q), heads_view(k), heads_view(v)))
            b_, s_, _ = q.shape
            bnd, by = bound_ms(4 * b_ * s_ * hd * q.element_size(),
                               4.0 * b_ * HEADS * s_ * s_ * 64, kind_dt)
            kernel_rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}
            print(f"[k1 {name}] shape {tuple(q.shape)} max_abs_err {err:.3e} "
                  f"(tol {KERNEL_TOL[kind_dt]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                  f"library {library_ms:.3f} ms bound {bnd:.3f} ms ({by})", flush=True)
            check(err <= KERNEL_TOL[kind_dt], f"K1 {name} disagrees with the plain version")
    del big, small, cases

    # 3b. K4 against the plain version: a 1024-px region (fused qkv layout),
    #     a sequence shard's rectangle, f32, and ragged lengths
    def fused(b, s, dtype, seed):
        t = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (b, s, 3 * HD), dtype=np.float32)).to(dev, dtype)
        return t[..., :HD], t[..., HD:2 * HD], t[..., 2 * HD:]

    q, k, v = fused(2, REGION_S, torch.bfloat16, SEED + 10)
    k4_region = k4_phase("bf16_region", q, k, v)
    with torch.inference_mode():
        k4_library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            heads_view(q), heads_view(k), heads_view(v)), reps=10)
    k4_bound, k4_by = bound_ms(4 * 2 * REGION_S * HD * 2 + 2 * HEADS * REGION_S * 4,
                               4.0 * 2 * HEADS * REGION_S * REGION_S * 64, "bf16")
    print(f"[k4 bf16_region] library {k4_library_ms:.3f} ms bound {k4_bound:.3f} ms ({k4_by})",
          flush=True)
    k4_phase("bf16_cross", q[:, :1334], k, v)
    # the same rectangle over keys padded to 5376 of which 5334 are live
    _, kp, vp = fused(2, 5376, torch.bfloat16, SEED + 11)
    kp[:, :REGION_S], vp[:, :REGION_S] = k, v
    k4_phase("bf16_cross_padded", q[:, :1334], kp, vp, REGION_S)
    del q, k, v, kp, vp
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
    del q, k, v, kp, vp
    k5_phase("f32", *fused(1, 1029, torch.float32, SEED + 24), seed=SEED + 25)
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

        attn.launch_counts["attention"] = 0
        t0 = time.perf_counter()
        out = predict_tiles(model, tiles, HOPTIMUS_HE, BATCH, dev)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = attn.launch_counts["attention"]
        depth = model.vit_cfg.depth
        n_batches = -(-N_TILES // BATCH)
        print(f"[slice] predict_tiles {out.shape} {out.dtype} in {e2e_s:.2f} s "
              f"(first call, includes warm-up); K1 launches {launches} "
              f"= {depth} blocks x {n_batches} batches", flush=True)
        check(out.shape == (N_TILES, IMG, IMG, MARKERS), f"output shape {out.shape}")
        check(out.dtype == np.uint8, f"output dtype {out.dtype}")
        check(launches == depth * n_batches, f"K1 launched {launches} times, "
              f"expected {depth * n_batches}")

        mean = torch.as_tensor(HOPTIMUS_HE.mean, device=dev)
        std = torch.as_tensor(HOPTIMUS_HE.std, device=dev)
        x = (torch.from_numpy(tiles[:BATCH]).to(dev).float() - mean) / std
        with torch.inference_mode():
            pred_bf16 = model(x)
            check(bool(torch.isfinite(pred_bf16).all()), "non-finite output in a batch")
            fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
            attn.launch_counts["attention"] = 0
        print(f"[throughput] {BATCH * 1000 / fwd_ms:.1f} tiles/s steady bf16 forward "
              f"at batch {BATCH} ({fwd_ms:.2f} ms/batch, CUDA events, median of 10) "
              f"on {card}", flush=True)
        pred_bf16 = pred_bf16[:1].cpu().numpy()

        # 4b. stitched whole-slide inference at 256-px windows (K1)
        slide = np.random.default_rng(SEED + 2).integers(0, 256, (SLIDE, SLIDE, 3),
                                                         dtype=np.uint8)
        wsi256, _ = wsi_phase("wsi 256", model, slide, IMG, 64, BATCH, dev)
        n_wsi = -(-len(range(0, SLIDE - 64, IMG - 64)) ** 2 // BATCH)   # 11 x 11 windows
        check(wsi256["attention"] == depth * n_wsi and wsi256["flash"] == 0,
              f"wsi 256 launched K1 {wsi256['attention']} and K4 {wsi256['flash']} times, "
              f"expected {depth * n_wsi} and 0")
        del model
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

        # 6. stitched whole-region inference at 1024-px windows (K4): the
        #    generator loaded at 1024 px, its position embedding re-gridded
        t0 = time.perf_counter()
        model = load(ckpt, enc, dev, torch.bfloat16, REGION)
        torch.cuda.synchronize()
        print(f"[load] at {REGION} px: load_generator + merge_lora + cast_params(bf16) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        wsi1024, _ = wsi_phase("wsi 1024", model, slide, REGION, 128, 4, dev)
        n_wsi = -(-len(range(0, SLIDE - 128, REGION - 128)) ** 2 // 4)   # 3 x 3 windows
        check(wsi1024["flash"] == depth * n_wsi and wsi1024["attention"] == 0,
              f"wsi 1024 launched K4 {wsi1024['flash']} and K1 {wsi1024['attention']} "
              f"times, expected {depth * n_wsi} and 0")

        # 7. region numerics: bf16 against f32 on the card at full depth, and
        #    f32 on the card (K4) against f32 on the CPU (plain) with the
        #    encoder cut to its first 2 blocks at full width
        t0 = time.perf_counter()
        xr = (torch.from_numpy(slide[None, :REGION, :REGION]).to(dev).float() - mean) / std
        with torch.inference_mode():
            region_bf16 = model(xr).cpu().numpy()
            del model
            torch.cuda.empty_cache()
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
        train256 = train_phase("train 256", model, data, 3, dev)
        n_micro = 3 * ACCUM
        check(train256["attention"] == depth * n_micro and train256["flash"] == 0
              and train256["flash_bwd"] == 0,
              f"train 256 launched K1 {train256['attention']}, K4 {train256['flash']}, "
              f"K5 {train256['flash_bwd']} times, expected {depth * n_micro}, 0, 0")
        del model
        torch.cuda.empty_cache()

        # 9. whole-region training at 1024 px, batch 1: K4 forward, K5 backward
        t0 = time.perf_counter()
        model = train_model(ckpt, enc, REGION, dev)
        print(f"[load] training generator at {REGION} px in {time.perf_counter() - t0:.1f} s",
              flush=True)
        region_data = train_batches(2 * ACCUM, REGION_MICRO, REGION, dev, SEED + 4)
        train1024 = train_phase("train 1024", model, region_data, 2, dev)
        n_micro = 2 * ACCUM
        check(train1024["flash"] == depth * n_micro and train1024["flash_bwd"] == depth * n_micro
              and train1024["attention"] == 0,
              f"train 1024 launched K4 {train1024['flash']}, K5 {train1024['flash_bwd']}, "
              f"K1 {train1024['attention']} times, expected {depth * n_micro} twice and 0")

        # 9b. the same with per-block activation checkpointing: each block's
        #     forward (K4) runs again in the backward, before its K5
        train1024c = train_phase("train 1024 ckpt", model, region_data, 2, dev,
                                 grad_checkpointing=True)
        check(train1024c["flash"] == 2 * depth * n_micro
              and train1024c["flash_bwd"] == depth * n_micro and train1024c["attention"] == 0,
              f"train 1024 ckpt launched K4 {train1024c['flash']}, K5 {train1024c['flash_bwd']}, "
              f"K1 {train1024c['attention']} times, expected {2 * depth * n_micro}, "
              f"{depth * n_micro} and 0")
        del model
        torch.cuda.empty_cache()

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

    # 11. summary lines
    k1 = kernel_rows["bf16_fused"]
    k4_err, _, k4_ms, k4_plain_ms = k4_region
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "k1_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:563",
         "launches": launches + wsi256["attention"] + train256["attention"], **k1,
         "launches_by_path": {"slice": launches, "wsi 256": wsi256["attention"],
                              "train 256": train256["attention"]}},
        {"name": "k4_flash_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:59",
         "launches": wsi1024["flash"] + train1024["flash"] + train1024c["flash"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": k4_library_ms,
         "launches_by_path": {"wsi 1024": wsi1024["flash"], "train 1024": train1024["flash"],
                              "train 1024 ckpt": train1024c["flash"]}},
        {"name": "k5_flash_attention_bwd", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:317",
         "launches": train1024["flash_bwd"] + train1024c["flash_bwd"], **k5_region,
         "launches_by_path": {"train 1024": train1024["flash_bwd"],
                              "train 1024 ckpt": train1024c["flash_bwd"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
