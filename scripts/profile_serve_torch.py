"""Where the time of the PyTorch port's serving forward goes, on one card.

    python3 scripts/profile_serve_torch.py [--sizes 256 1024] [--batches 64 4]

Builds the flagship generator for serving as ``chip_smoke.py`` does
(H-Optimus-0 ViT-g/14 at full width and depth, 16 markers, random weights
from a numpy seed; load_generator(fast_heads=True) -> merge_lora ->
cast_params(bf16)) and, for each size at its batch (256 px at 64, 1024 px
at 4), after two warm-up forwards: times the forward with CUDA events
(median of 5), then takes a ``torch.profiler`` trace of 3 forwards and
prints the device time per forward of its kernels by group (K1, K2, K3,
K4, GEMM, convolution, elementwise and reductions, ...), the top kernels,
and the device busy share over the traced wall time.

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
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from profile_train_torch import group_of  # noqa: E402

TRACED = 3


def profile_forward(ckpt, enc, img, batch, dev):
    from torch.profiler import ProfilerActivity, profile

    model = cs.load(ckpt, enc, dev, torch.bfloat16, img)
    x = torch.from_numpy(np.random.default_rng(cs.SEED + 7).standard_normal(
        (batch, img, img, 3), dtype=np.float32)).to(dev)
    with torch.inference_mode():
        fwd_ms = cs.cuda_ms(lambda: model(x), reps=5, warmup=2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACED):
                model(x)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    kernels = {}   # name -> (ms, count), device-side events only
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((ms / TRACED, n // TRACED, name) for name, (ms, n) in kernels.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    by_group = {}
    for ms, _, name in rows:
        by_group[group_of(name)] = by_group.get(group_of(name), 0.0) + ms
    tag = f"{img} px, batch {batch}"
    print(f"[profile {tag}] bf16 forward {fwd_ms:.2f} ms (CUDA events, median of 5) = "
          f"{batch * 1e3 / fwd_ms:.1f} images/s; traced {TRACED} forwards in {wall:.1f} ms wall, "
          f"device busy {busy:.2f} ms per forward = share {TRACED * busy / wall:.3f}", flush=True)
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile {tag}]   {group:22s} {ms:9.2f} ms  {100 * ms / busy:5.1f} %", flush=True)
    for ms, count, name in rows[:20]:
        print(f"[profile {tag}]     {ms:8.3f} ms  x{count:<4d} {name[:110]}", flush=True)
    del model, x
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[cs.IMG, cs.REGION])
    ap.add_argument("--batches", type=int, nargs="+", default=[cs.BATCH, 4])
    args = ap.parse_args()
    if len(args.sizes) != len(args.batches):
        raise SystemExit("--sizes and --batches take one value each per run")
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    from concurrent.futures import ThreadPoolExecutor

    from mipheivit_tpu_torch import _build

    kernels = ("attention", "flash_attention", "swiglu", "seg_heads")
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_build.build, kernels))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, enc, _ = cs.write_checkpoint(Path(tmp), cs.SEED)
        for img, batch in zip(args.sizes, args.batches):
            profile_forward(ckpt, enc, img, batch, dev)


if __name__ == "__main__":
    main()
