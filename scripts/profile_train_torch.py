"""Where the time of the PyTorch port's training step goes, on one card.

    python3 scripts/profile_train_torch.py [--sizes 256 1024] [--checkpointed 1024]

Builds the flagship generator for training as ``chip_smoke.py`` does
(H-Optimus-0 ViT-g/14 at full width and depth, 16 markers, random weights
from a numpy seed, LoRA live, per-head decoder, frozen encoder stored
bf16) and, for each size (256 px at microbatch 8, 1024 px at microbatch 1;
accumulation 2), and again with per-block activation checkpointing for
the sizes in ``--checkpointed``, after two warm-up optimizer steps:

  * times the phases of one microbatch with CUDA events: forward with the
    loss, backward (``torch.autograd.grad`` of the trainable weights), the
    optimizer chain, the pixel-metric update; and one whole optimizer step
    of two microbatches through ``make_train_step``;
  * takes a ``torch.profiler`` trace of one optimizer step and prints the
    device time of its kernels by group (K1, K2 and its backward terms, K4,
    K5, GEMM, convolution, elementwise and reductions, ...) and the top
    kernels, with the device busy share over the step's wall time.

Prints the card's name and power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("K5", ("bwd_bf16_kernel", "bwd_prep_kernel", "dq_cast_kernel", "dkdv_f32", "dq_f32")),
    ("K4", ("flash_bf16_kernel", "flash_f32_kernel")),
    ("K1", ("attn_bf16_kernel", "attn_f32_kernel")),
    ("K2", ("gemm_ws_kernel<false, true>", "gemm_ws_kernel<true, true>", "gemm_f32_kernel<true>")),
    ("K7", ("gemm_ws_kernel<true, false>", "gemm_f32_kernel<false>")),
    ("K2 backward terms", ("gate_bwd_kernel",)),
    ("K3", ("heads_ws_kernel", "heads_f32_kernel")),
    ("GEMM", ("gemm", "Gemm", "xmma", "nvjet", "cutlass", "sm90_", "ampere_")),
    ("convolution (cuDNN)", ("conv", "Conv", "cudnn", "implicit", "winograd", "fft", "dgrad",
                             "wgrad", "fprop", "nhwc", "nchw")),
    ("reduction", ("reduce", "Reduce", "norm", "Norm", "softmax", "Softmax")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized", "unrolled", "Copy", "copy",
                     "fill", "Fill", "where", "index")),
    ("interpolate", ("upsample", "interp")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def events_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def profile_size(ckpt, enc, img, micro, dev, grad_checkpointing=False):
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.train.losses import marker_weights_from_stds, weighted_mse_loss
    from mipheivit_tpu_torch.train.optim import AdamChain

    model = cs.train_model(ckpt, enc, img, dev)
    state, step = cs.train_setup(model, dev, torch.bfloat16, grad_checkpointing)
    tag = f"{img} ckpt" if grad_checkpointing else f"{img}"
    data = cs.train_batches(2 * cs.ACCUM, micro, img, dev, cs.SEED + 3)
    metrics = PixelMetrics.zeros(dev)
    for batch in data:                       # two warm-up optimizer steps
        state, metrics, _ = step(state, batch, metrics)
    torch.cuda.synchronize()

    # phases of one microbatch, outside the step function, same calls
    stds = np.random.default_rng(cs.SEED + 5).uniform(0.1, 0.3, cs.MARKERS)
    loss_fn = weighted_mse_loss(cs.LAMBDA, marker_weights_from_stds(stds))
    params = [p for _, p in state.gen_params]
    x, y = data[0]["image"], data[0]["target"]

    def forward():
        f = model(x)
        return f, loss_fn(y, f)

    fwd_ms, (fake, loss) = events_ms(forward)
    bwd_ms, grads = events_ms(lambda: torch.autograd.grad(loss, params))
    opt = AdamChain(1e-9, cs.TOTAL_ITERS)            # the chain's arithmetic, one emit per call
    state_opt = opt.init(params)
    opt_ms, _ = events_ms(lambda: opt.step(params, grads, state_opt))
    met_ms, _ = events_ms(lambda: metrics.update(torch.clamp(fake.detach(), -0.9, 0.9), y))
    del fake, loss, grads, state_opt

    t0 = time.perf_counter()
    for batch in data[:cs.ACCUM]:
        state, metrics, _ = step(state, batch, metrics)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in data[cs.ACCUM:2 * cs.ACCUM]:
            state, metrics, _ = step(state, batch, metrics)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)

    kernels = {}   # name -> (ms, count), device-side events only
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((ms, n, name) for name, (ms, n) in kernels.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    by_group = {}
    for ms, _, name in rows:
        by_group[group_of(name)] = by_group.get(group_of(name), 0.0) + ms

    print(f"[profile {tag}] microbatch {micro}, accumulation {cs.ACCUM}: one microbatch "
          f"forward+loss {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, optimizer chain "
          f"{opt_ms:.1f} ms ({len(params)} tensors), metrics {met_ms:.1f} ms; one optimizer step "
          f"through make_train_step {step_ms:.1f} ms (host clock); profiled step "
          f"{prof_wall:.1f} ms wall, device busy {busy:.1f} ms = share "
          f"{busy / prof_wall:.3f}", flush=True)
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile {tag}]   {group:22s} {ms:9.2f} ms  {100 * ms / busy:5.1f} %",
              flush=True)
    for ms, count, name in rows[:25]:
        print(f"[profile {tag}]     {ms:8.2f} ms  x{count:<5d} {name[:110]}", flush=True)
    del model, state, step, data
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[cs.IMG, cs.REGION])
    ap.add_argument("--checkpointed", type=int, nargs="*", default=[cs.REGION],
                    help="sizes profiled again with per-block activation checkpointing")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    from concurrent.futures import ThreadPoolExecutor

    from mipheivit_tpu_torch import _build

    kernels = ("attention", "flash_attention", "flash_attention_bwd", "swiglu", "seg_heads")
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_build.build, kernels))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, enc, _ = cs.write_checkpoint(Path(tmp), cs.SEED)
        runs = [(img, False) for img in args.sizes] + [(img, True) for img in args.checkpointed]
        for img, grad_checkpointing in runs:
            micro = cs.MICRO if img == cs.IMG else cs.REGION_MICRO
            profile_size(ckpt, enc, img, micro, dev, grad_checkpointing)


if __name__ == "__main__":
    main()
