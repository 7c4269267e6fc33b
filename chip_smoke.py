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
# [train ops]: each gradient of the bf16 backward on the card against the
# f32 backward on the CPU, cosine (bf16 rounds the inputs, q/k/v, p and the
# output once each)
OPS_GRAD_COS = 0.999
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
    """K4 against its plain version on one input (keys past ``seq_len_k``
    may hold NaN or Inf: the plain version sees the live keys only); prints
    and checks the errors and times the kernel, the plain version and the
    library's attention on the live keys, with the bound. Returns the row's
    numbers."""
    import torch.nn.functional as F

    from mipheivit_tpu_torch.ops import attention as attn

    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    live = seq_len_k or k.shape[1]
    kl, vl = k[:, :live], v[:, :live]
    t0 = time.perf_counter()
    with torch.inference_mode():
        out, lse = attn.flash_attention(q, k, v, HEADS, seq_len_k)
        want_out, want_lse = attn.flash_reference(q, kl, vl, HEADS)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        out_err, out_rel, out_fro = scaled_err(out, want_out)
        lse_err = (lse - want_lse).abs().max().item()
        del out, lse, want_out, want_lse
        ms = cuda_ms(lambda: attn.flash_attention(q, k, v, HEADS, seq_len_k), reps=10)
        plain_ms = cuda_ms(lambda: attn.flash_reference(q, kl, vl, HEADS), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            heads_view(q), heads_view(kl), heads_view(vl)), reps=10)
    b, sq, hd = q.shape
    n_bytes = (2 * b * sq * hd + 2 * b * live * hd) * q.element_size() + b * HEADS * sq * 4
    bnd, by = bound_ms(n_bytes, 4.0 * b * HEADS * sq * live * 64, dt)
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


def k5_phase(name, q, k, v, seq_len_k=None, seed=0):
    """K5 against its plain version on K4's output for one input and a
    random output gradient; prints and checks the dq/dk/dv errors and times
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
    n_bytes = 4 * b * (sq + k.shape[1]) * hd * q.element_size() + b * HEADS * sq * 4
    bnd, by = bound_ms(n_bytes, 10.0 * b * HEADS * sq * live * 64, dt)
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


def head_flops_per_px(k):
    """K3's operations per pixel at k heads: gate 32 x 16k, psi-conv2 16k,
    taps 32 x 9k (2 per multiply-add) and the 9k-term stencil."""
    return 2 * (HEAD_C * 16 * k + 16 * k + HEAD_C * 9 * k + 9 * k)


def seeded_heads(seed, device, k=MARKERS):
    """A BatchedSegHeads (32 channels, k markers) in eval mode with weights,
    biases and BN statistics from a numpy seed."""
    from mipheivit_tpu_torch.models.mipheivit import BatchedSegHeads

    rng = np.random.default_rng(seed)
    heads = BatchedSegHeads(HEAD_C, k)
    with torch.no_grad():
        for p in heads.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape), dtype=np.float32)
                                     * np.float32(0.1)))
        heads.psi_bn.running_mean.copy_(torch.from_numpy(
            rng.standard_normal(16 * k, dtype=np.float32) * np.float32(0.1)))
        heads.psi_bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, 16 * k).astype(np.float32)))
    return heads.to(device).eval()


def k3_phase(name, b, h, w, dtype, seed=0, k=MARKERS):
    """K3 against its plain version on one decoder feature map [b, 32, h, w]
    (channels_last) with k seeded heads; prints and checks the scaled errors
    and times the kernel, the plain version and the module's plain eval
    chain (cuDNN 1x1 convs, the running-statistics BatchNorm, nine addcmul_;
    the library yardstick). Returns the row's numbers."""
    from mipheivit_tpu_torch.ops import seg_heads

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    heads = seeded_heads(seed, dev, k)
    weights = seg_heads.fold_heads(heads, dtype)
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, h, w, HEAD_C), dtype=np.float32)).to(dev, dtype).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = seg_heads.fused_seg_heads(x, *weights)
        want = seg_heads.seg_heads_reference(x, *weights)
        torch.cuda.synchronize()
        err, rel, fro = scaled_err(got, want)
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: seg_heads.fused_seg_heads(x, *weights), reps=10)
        plain_ms = cuda_ms(lambda: seg_heads.seg_heads_reference(x, *weights), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: heads.chain(x), reps=5, warmup=1)
    n_px = b * h * w
    bnd, by = bound_ms(n_px * (HEAD_C + k) * x.element_size(), 1.0 * n_px * head_flops_per_px(k),
                       dt)
    print(f"[k3 {name}] x [{b}, {HEAD_C}, {h}, {w}] -> [{b}, {k}, {h}, {w}]: max_abs_err "
          f"{err:.3e} = {rel:.2e} of max|ref|, norm-rel {fro:.2e} (tol {SCALED_TOL[dt][0]:g}, "
          f"{SCALED_TOL[dt][1]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms library (cuDNN "
          f"eval chain) {library_ms:.3f} ms bound {bnd:.3f} ms ({by}) "
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
    attention entry points at head dims above 64 (attention_qkv at 24 heads
    of 80 and S 329, K1's; attention_bshd at 24 heads of 128 and S 600,
    K4's; flash_backward there, K5's; dot_product_attention at D 80, K6's)
    and ln_qkv_attention at 2 heads of 80 (K8's). Each must raise ValueError
    with no kernel launch: on the card an entry point launches its kernels
    or raises. (Head dims below 64 that are not multiples of 8, such as 36,
    reach the kernels padded to 64; widths that are not multiples of 8, as
    ln_matmul at K 100 and ln_qkv_attention at D 100, reach K7, K2 and K8
    zero-padded: both moved to [head dims] and [ln_qkv routes], as the JAX
    entry points serve them.)"""
    from mipheivit_tpu_torch.ops import attention as attn
    from mipheivit_tpu_torch.ops import attn_block

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    qkv80 = seeded((2, 329, 3 * HEADS * 80), SEED + 120, bf16)
    long_q, long_k, long_v = seeded((1, 600, 3 * HEADS * 128), SEED + 121, bf16).chunk(3, -1)
    g = seeded((1, 600, HEADS * 128), SEED + 122, bf16)
    out, lse = attn.flash_reference(long_q, long_k, long_v, HEADS)
    heads = [seeded((2, HEADS, 329, 80), SEED + 123 + i, bf16) for i in range(3)]
    x80 = seeded((2, 329, HD), SEED + 130, bf16)
    lns80, lnb80 = ln_params(HD, SEED + 131)
    w80, b80 = seeded((3 * 2 * 80, HD), SEED + 132, bf16, HD ** -0.5), seeded(480, SEED + 133, bf16)
    cases = {
        "attention_qkv [2, 329, 24x80]": lambda: attn.attention_qkv(qkv80, HEADS),
        "attention_bshd [1, 600, 24x128]": lambda: attn.attention_bshd(long_q, long_k, long_v,
                                                                       HEADS),
        "flash_backward [1, 600, 24x128]": lambda: attn.flash_backward(
            long_q, long_k, long_v, out, lse, g, HEADS),
        "dot_product_attention [2, 24, 329, 80]": lambda: attn.dot_product_attention(*heads),
        "ln_qkv_attention [2, 329, 1536], 2 heads of 80": lambda: attn_block.ln_qkv_attention(
            x80, lns80, lnb80, w80, b80, 2),
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
          f"{counts_line(counts)}; serial-stitch max diff "
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

    # 3b. K4 against the plain version: a 1024-px region (fused qkv layout),
    #     a sequence shard's rectangle, f32, and ragged lengths
    def fused(b, s, dtype, seed):
        t = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (b, s, 3 * HD), dtype=np.float32)).to(dev, dtype)
        return t[..., :HD], t[..., HD:2 * HD], t[..., 2 * HD:]

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
    #     their kernels' widths (zero-padded), ln_qkv_attention's routes
    #     beyond ViT-g's shape; what no kernel takes raises on the card,
    #     before any launch
    head_dims_phase()
    ln_qkv_routes_phase()
    rejects_phase()

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
            pred_bf16 = model(x)
            check(bool(torch.isfinite(pred_bf16).all()), "non-finite output in a batch")
            fwd_ms = cuda_ms(lambda: model(x), reps=10, warmup=2)
        print(f"[throughput] {BATCH * 1000 / fwd_ms:.1f} tiles/s steady bf16 forward "
              f"at batch {BATCH} ({fwd_ms:.2f} ms/batch, CUDA events, median of 10) "
              f"on {card}", flush=True)
        pred_bf16 = pred_bf16[:1].cpu().numpy()

        # 4a. block 0's attention sublayer three ways (K1, K7 + K1, K8) on
        #     the loaded generator's weights and the tokens of 64 tiles
        sublayer = attn_sublayer_phase(model, x)

        # 4b. the serving daemon on the same generator
        serve_counts, _ = serve_phase(model, dev)

        # 4c. stitched whole-slide inference at 256-px windows (K1)
        slide = np.random.default_rng(SEED + 2).integers(0, 256, (SLIDE, SLIDE, 3),
                                                         dtype=np.uint8)
        wsi256, _ = wsi_phase("wsi 256", model, slide, IMG, 64, BATCH, dev)
        n_wsi = -(-len(range(0, SLIDE - 64, IMG - 64)) ** 2 // BATCH)   # 11 x 11 windows
        check_counts("[wsi 256]", wsi256, k1=depth * n_wsi, k2=depth * n_wsi, k3=n_wsi)
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
        check_counts("[wsi 1024]", wsi1024, k4=depth * n_wsi, k2=depth * n_wsi, k3=n_wsi)

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
        train1024 = train_phase("train 1024", model, region_data, 2, dev)
        n_micro = 2 * ACCUM
        check_counts("[train 1024]", train1024, k4=depth * n_micro, k5=depth * n_micro,
                     k2=depth * n_micro, k2b=depth * n_micro)

        # 9b. the same with per-block activation checkpointing: each block's
        #     forward (K4) runs again in the backward, before its K5
        train1024c = train_phase("train 1024 ckpt", model, region_data, 2, dev,
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

    # 11. summary lines
    k1 = kernel_rows["bf16_fused"]
    paths = {"slice": slice_counts, "attn sublayer": sublayer, "serve": serve_counts,
             "wsi 256": wsi256, "wsi 1024": wsi1024, "train 256": train256,
             "train 1024": train1024, "train 1024 ckpt": train1024c, "train ops": train_ops}

    def launches(key):
        by_path = {path: c[key] for path, c in paths.items() if c[key]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "k1_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:563", **k1, **launches("attention")},
        {"name": "k4_flash_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:59", **k4_region, **launches("flash")},
        {"name": "k5_flash_attention_bwd", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:317", **k5_region,
         **launches("flash_bwd")},
        {"name": "k2_swiglu", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/swiglu.cu",
         "replaces": "mipheivit_tpu/ops/mlp.py:51", **k2_flagship, **launches("swiglu")},
        {"name": "k2_swiglu_bwd_gate", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/swiglu.cu",
         "replaces": "mipheivit_tpu/ops/mlp.py:159", **k2b_flagship, **launches("swiglu_bwd")},
        {"name": "k3_seg_heads", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/seg_heads.cu",
         "replaces": "mipheivit_tpu/ops/seg_heads.py:38", **k3_flagship,
         **launches("seg_heads")},
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
