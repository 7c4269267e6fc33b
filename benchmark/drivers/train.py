"""Region fine-tuning through ``train.steps.make_train_step``: the
configuration's LoRA step on seeded H&E regions and marker targets,
uploaded step by step through the trainer's ``device_prefetch``.

Set-up builds one train state, drives it through its first optimizer steps
(every microbatch a different region) and hands the same state to the
window. From those steps it keeps each microbatch's loss, the first
step's clipped gradient (worked out from Adam's first moment: ``mu / (1 -
b1)`` after one step) and each trainable tensor's change. After the window
the reference runs the same steps from the same weights and inputs.

``train_img_s`` is the regions consumed by the optimizer steps completed in
the window over the time to a synchronize after the last one. A step whose
loss is not finite counts as failed."""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from benchmark import compare, inputs, program
from benchmark.reference import models as ref, strict_f32
from benchmark.reference import train as ref_train
from benchmark.work import model as model_work

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def batches(cfg, tr, seed, device):
    """The pool of distinct host microbatches: normalized f32 images and
    f32 targets."""
    n, b, img = tr["pool_microbatches"], tr["microbatch"], tr["img"]
    mean = torch.tensor(cfg["he_mean"], device=device)
    std = torch.tensor(cfg["he_std"], device=device)
    out = []
    for i in range(n):
        x = (inputs.he_images(b, img, seed, device, stream=100 + i).float() - mean) / std
        y = inputs.mif_targets(b, img, cfg["markers"], seed, device, stream=200 + i)
        out.append({"image": x.cpu().numpy(), "target": y.cpu().numpy()})
    return out


def optimizer_settings(cfg, tr):
    stds = np.asarray(tr["marker_stds"], np.float64)
    w = (1.0 / stds) / (1.0 / stds).min()
    return {"lr": tr["learning_rate"], "warmup": tr["warmup_iters"],
            "total_iters": tr["total_iters"], "clip": tr["clip"], "b1": tr["b1"],
            "b2": tr["b2"], "eps": tr["eps"], "accum": tr["accum"], "lambda": tr["lambda"],
            "marker_weights": w.tolist()}


def program_state(cfg, tr, seed, device):
    from mipheivit_tpu_torch.train import (build_generator_optimizer, create_train_state,
                                           make_train_step, weighted_mse_loss)
    from mipheivit_tpu_torch.train.losses import marker_weights_from_stds

    model = program.seeded(program.generator(cfg, tr["img"], device), cfg, seed)
    opt = build_generator_optimizer(tr["learning_rate"], tr["total_iters"], tr["warmup_iters"],
                                    grad_accum_steps=tr["accum"])
    chain = (opt.max_norm, opt.b1, opt.b2, opt.eps)
    if chain != (tr["clip"], tr["b1"], tr["b2"], tr["eps"]):
        raise RuntimeError(f"the program's chain {chain} is not the traffic's")
    state = create_train_state(model, opt, freeze_model_name=cfg["generator"],
                               frozen_dtype=DTYPES[tr["frozen_dtype"]], seed=seed % 2 ** 63,
                               device=device)
    loss = weighted_mse_loss(tr["lambda"], marker_weights_from_stds(tr["marker_stds"]))
    return model, state, make_train_step(model, loss, opt)


def run(r):
    from mipheivit_tpu_torch.data.pipeline import device_prefetch
    from mipheivit_tpu_torch.metrics import PixelMetrics

    cfg, tr, dev = r.config, r.traffic, r.device
    k, first = tr["accum"], tr["checked_steps"]
    pool = batches(cfg, tr, r.seed, dev)
    model, state, step = program_state(cfg, tr, r.seed, dev)
    feed = device_prefetch(itertools.cycle(pool), size=2, device=dev)
    metrics = PixelMetrics.zeros(dev)
    names = [n for n, _ in state.gen_params]
    start = {n: p.detach().float().clone() for n, p in state.gen_params}
    losses, first_grad = [], None
    for s in range(first):
        for _ in range(k):
            state, metrics, log = step(state, next(feed), metrics)
            losses.append(log["gen_loss"])
        if s == 0:
            first_grad = {n: (m / (1.0 - tr["b1"])).detach().clone()
                          for n, m in zip(names, state.gen_opt_state.mu)}
    got = {"losses": [float(v) for v in losses], "first_grad": first_grad,
           "change": {n: p.detach().float() - start[n] for n, p in state.gen_params}}
    del start
    r.instrument(model)
    t0 = r.begin_window()
    deadline = t0 + r.seconds
    steps, step_losses = 0, []
    while time.perf_counter() < deadline:
        for _ in range(k):
            state, metrics, log = step(state, next(feed), metrics)
            step_losses.append(log["gen_loss"])
        steps += 1
    t1 = r.end_window()
    window = t1 - t0
    finite = torch.isfinite(torch.stack(step_losses)).view(steps, k).all(dim=1)
    r.failed = int((~finite).sum())
    r.attempted = steps
    r.e2e["train_img_s"] = steps * k * tr["microbatch"] / window
    r.stats.update(units=steps, window_s=window, batches=steps * k,
                   model_flops=model_work.train_flops(cfg, tr["img"], tr["microbatch"]) * k)
    r.read_peak()
    del model, state, step, feed, metrics, log, step_losses
    r.free()
    strict_f32()
    t2 = time.perf_counter()
    p = ref.seeded_params(cfg, tr["img"], r.seed, dev)
    data = [{key: torch.from_numpy(v).to(dev) for key, v in b.items()}
            for b in pool[:first * k]]
    want = ref_train.run_steps(cfg, p, data, optimizer_settings(cfg, tr), first)
    nums = compare.training(got, want)
    print(f"[numbers] {r.cell.name} seed {r.seed}: losses {got['losses']} reference "
          f"{want['losses']}; " + " ".join(f"{k_} {v!r}" for k_, v in nums.items())
          + f" (reference {time.perf_counter() - t2:.1f} s)", file=sys.stderr, flush=True)
    r.numbers = nums
    for name in r.cell.limits:
        r.check(name, nums[name], r.limit(name))


def control(r, fault=None):
    """The control at the cell's size: the reference in float8 e4m3 (the
    operands of every product) in the program's place; or, with ``fault``, the f32 reference
    with a planted fault in the program's place: ``half_batch`` (each
    optimizer step's mean over its first microbatch alone). A step that
    returns its state unchanged reads ``change_gap`` 1 by its definition
    and needs no run."""
    cfg, tr, dev = r.config, r.traffic, r.device
    k, first = tr["accum"], tr["checked_steps"]
    pool = batches(cfg, tr, r.seed, dev)
    data = [{key: torch.from_numpy(v).to(dev) for key, v in b.items()} for b in pool[:first * k]]
    strict_f32()
    opt = optimizer_settings(cfg, tr)
    want = ref_train.run_steps(cfg, ref.seeded_params(cfg, tr["img"], r.seed, dev), data, opt,
                               first)
    if fault == "half_batch":
        fed = [data[(i // k) * k] for i in range(len(data))]
        got = ref_train.run_steps(cfg, ref.seeded_params(cfg, tr["img"], r.seed, dev), fed, opt,
                                  first)
    elif fault is None:
        got = ref_train.run_steps(cfg, ref.seeded_params(cfg, tr["img"], r.seed, dev), data, opt,
                                  first, quant="fp8")
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return fault or "reference fp8", compare.training(got, want)
