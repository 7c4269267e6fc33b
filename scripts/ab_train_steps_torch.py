"""Forward and training-step times of one tree of the PyTorch port, on one
card, measured the same way whatever the tree.

    python3 scripts/ab_train_steps_torch.py [--root DIR] [--steps 6] [--label NAME]

Imports the port and ``chip_smoke.py`` of ``DIR`` (default: this checkout),
builds that tree's kernels from its sources, and drives its generators at
full width with ``chip_smoke.fresh_generator``'s seeded weights:

  * forwards, bf16 at 256 px: ``smp_unet`` on ConvNeXt-large with the
    foreground head (batch 16), ``unet_lora`` on ctranspath (batch 64) and
    ``hemit`` (batch 16): three rounds of the CUDA-event median of 10 calls,
    then the device time of one call from a profiler trace of 10;
  * training steps, f32 parameters and bf16 compute, one optimizer step a
    microbatch: ``unet_lora`` on H-Optimus-0 (8 tiles), ``smp_unet`` with
    the foreground term (16), ``unet_lora`` on ctranspath (16) and
    ``hemit`` (4): two warm-up steps, then ``--steps`` steps each timed with
    CUDA events and the host clock, then the device time of one step from a
    profiler trace of 3.

A generator the tree does not build prints as refused. Every phase runs in
the same order in every tree, so a run of parent, change, change, parent in
one call compares two trees on one card. Prints the card's name and power
limit first and a JSON object of the medians last. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

FORWARDS = (("smp convnext", "smp_unet", "tu-convnext_large", 16, {"foreground_head": True}),
            ("unetr ctranspath", "unet_lora", "ctranspath", 64, {}),
            ("hemit", "hemit", None, 16, {}))
TRAINS = (("train unetr", "unet_lora", "hoptimus0", 8, {}),
          ("train convnext fg", "smp_unet", "tu-convnext_large", 16, {"foreground_head": True}),
          ("train ctranspath", "unet_lora", "ctranspath", 16, {}),
          ("train hemit", "hemit", None, 4, {}))
KERNELS = ("attention", "flash_attention", "flash_attention_bwd", "swiglu", "seg_heads",
           "attn_block")


def build(cs, tag, model_name, encoder_name, dev, seed, kw):
    try:
        return cs.fresh_generator(model_name, encoder_name, dev, seed, **kw)
    except (NotImplementedError, KeyError, ValueError) as e:
        print(f"[ab {tag}] refused: {type(e).__name__}: {e}", flush=True)
        return None


def forward_phase(cs, tag, model_name, encoder_name, batch, kw, dev, seed):
    from mipheivit_tpu_torch.infer import cast_params

    model = build(cs, tag, model_name, encoder_name, dev, seed, kw)
    if model is None:
        return None
    cast_params(model, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (batch, cs.IMG, cs.IMG, 3), dtype=np.float32)).to(dev)
    with torch.inference_mode():
        rounds = [cs.cuda_ms(lambda: model(x), reps=10, warmup=2) for _ in range(3)]
        dev_ms = cs.device_ms(lambda: model(x), reps=10)
    del model
    torch.cuda.empty_cache()
    med = float(np.median(rounds))
    print(f"[ab {tag}] {model_name} / {encoder_name} bf16 forward at batch {batch}: "
          f"{', '.join(f'{v:.2f}' for v in rounds)} ms (three CUDA-event medians of 10) = "
          f"{batch * 1000 / med:.1f} tiles/s; device time {dev_ms:.2f} ms a call (profiler, "
          f"10 calls)", flush=True)
    return {"ms": med, "tiles/s": batch * 1000 / med, "device ms": dev_ms}


def train_phase(cs, tag, model_name, encoder_name, micro, kw, dev, seed, n_steps):
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.models.layers import set_compute_dtype
    from mipheivit_tpu_torch.train import (StepConfig, build_generator_optimizer,
                                           create_train_state, make_train_step, scaled_lr,
                                           weighted_mse_loss)
    from mipheivit_tpu_torch.train.losses import marker_weights_from_stds

    model = build(cs, tag, model_name, encoder_name, dev, seed, kw)
    if model is None:
        return None
    set_compute_dtype(model, torch.bfloat16)
    opt = build_generator_optimizer(scaled_lr(cs.LR_G, micro), cs.TOTAL_ITERS, warmup_iters=1)
    state = create_train_state(model, opt, freeze_model_name=model_name, seed=cs.SEED, device=dev)
    stds = np.random.default_rng(cs.SEED + 5).uniform(0.1, 0.3, cs.MARKERS)
    step = make_train_step(model, weighted_mse_loss(cs.LAMBDA, marker_weights_from_stds(stds)),
                           opt, cfg=StepConfig(foreground_head=bool(kw.get("foreground_head"))))
    data = cs.train_batches(2, micro, cs.IMG, dev, cs.SEED + 33)
    box = {"state": state, "metrics": PixelMetrics.zeros(dev), "i": 0}

    def one():
        box["state"], box["metrics"], log = step(box["state"], data[box["i"] % 2],
                                                 box["metrics"])
        box["i"] += 1
        return log

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, host, losses = [], [], []
    for _ in range(2 + n_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        log = one()
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        events.append(start.elapsed_time(end))
        losses.append(float(log["gen_loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dev_ms = cs.device_ms(one, reps=3)
    del model, state, box, step, opt
    torch.cuda.empty_cache()
    med = float(np.median(events[2:]))
    check = "finite" if np.isfinite(losses).all() else "NON-FINITE"
    print(f"[ab {tag}] {model_name} / {encoder_name}, microbatch {micro} at {cs.IMG} px: "
          f"{med:.1f} ms a step (CUDA events, median of {n_steps} after 2 warm-up steps; all "
          f"{', '.join(f'{v:.1f}' for v in events)}; host clock "
          f"{', '.join(f'{v:.1f}' for v in host)}) = {micro * 1000 / med:.2f} images/s; device "
          f"time {dev_ms:.1f} ms a step (profiler, 3 steps); peak memory {peak:.2f} GiB; "
          f"losses {check}", flush=True)
    return {"ms": med, "images/s": micro * 1000 / med, "device ms": dev_ms,
            "min ms": float(min(events[2:])), "max ms": float(max(events[2:])), "peak GiB": peak}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the tree whose port and chip_smoke.py to measure")
    ap.add_argument("--steps", type=int, default=6, help="timed steps after the warm-up")
    ap.add_argument("--label", default="tree", help="a name printed on every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device; this script runs only on the card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from mipheivit_tpu_torch import _build

    print(f"{cs.card_line()} {args.label} ({Path(cs.__file__).resolve().parent})", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    out = {}
    for i, (tag, name, enc, batch, kw) in enumerate(FORWARDS):
        out[tag] = forward_phase(cs, tag, name, enc, batch, kw, dev, cs.SEED + 200 + i)
    for i, (tag, name, enc, micro, kw) in enumerate(TRAINS):
        out[tag] = train_phase(cs, tag, name, enc, micro, kw, dev, cs.SEED + 210 + i, args.steps)
    print(json.dumps({"label": args.label, **out}), flush=True)


if __name__ == "__main__":
    main()
