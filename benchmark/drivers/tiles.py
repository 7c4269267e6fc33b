"""Tile batches through ``infer.tiles.predict_tiles``: a pool of seeded
uint8 H&E tiles, whole calls over the pool back to back.

``tiles_s`` is the tiles returned by the calls completed in the window over
the time from the window's start to the last completion. After the window
a sample of the tiles, drawn from the seed, from a call drawn from the seed
(a reservoir over the calls) is held against the reference."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import compare, inputs, program
from benchmark.reference import models as ref, serving, strict_f32
from benchmark.work import model as model_work


def reference_u8(cfg, tiles: np.ndarray, seed: int, device, chunk: int = 8, quant=None):
    strict_f32()
    img = tiles.shape[1]
    scfg, p = ref.merged(cfg, ref.seeded_params(cfg, img, seed, device))
    outs = []
    with torch.no_grad():
        for i in range(0, len(tiles), chunk):
            x = serving.normalize(torch.from_numpy(tiles[i:i + chunk]).to(device),
                                  cfg["he_mean"], cfg["he_std"])
            outs.append(serving.codec(ref.forward(scfg, p, x, quant=quant)).cpu().numpy())
    f = np.concatenate(outs)
    return f.astype(np.uint8), f


def control(r):
    """The control at the cell's size: the program's own int8 path where it
    has one (``int8_path`` in the configuration), else the reference in
    float8 e4m3 in the program's place, over one call's tiles; the same sample."""
    from mipheivit_tpu_torch.infer import predict_tiles

    cfg, tr, dev = r.config, r.traffic, r.device
    img, bs = tr["tile"], tr["batch"]
    pool = inputs.he_images(tr["pool"], img, r.seed, dev).cpu().numpy()
    idx = np.sort(np.random.default_rng(r.seed % 2 ** 63).choice(len(pool), tr["check_tiles"],
                                                                  replace=False))
    if cfg.get("int8_path"):
        model = program.serving_model(cfg, img, r.seed, dev, int8=True)
        got = predict_tiles(model, pool, program.normalizer(cfg), bs)[idx]
        del model
        r.free()
        what = "program int8"
    else:
        got = reference_u8(cfg, pool[idx], r.seed, dev, quant="fp8")[0]
        what = "reference fp8"
    ref_u8, ref_f = reference_u8(cfg, pool[idx], r.seed, dev)
    return what, compare.served(got, ref_u8, ref_f)


def run(r):
    from mipheivit_tpu_torch.infer import predict_tiles

    cfg, tr, dev = r.config, r.traffic, r.device
    img, bs = tr["tile"], tr["batch"]
    model = program.serving_model(cfg, img, r.seed, dev)
    norm = program.normalizer(cfg)
    pool = inputs.he_images(tr["pool"], img, r.seed, dev).cpu().numpy()
    predict_tiles(model, pool[:bs * tr["warmup_batches"]], norm, bs)
    r.instrument(model)
    rng = np.random.default_rng(r.seed % 2 ** 63)
    t0 = r.begin_window()
    deadline = t0 + r.seconds
    calls = done = 0
    t_last, kept = t0, None
    while time.perf_counter() < deadline:
        out = predict_tiles(model, pool, norm, bs)
        t_last = time.perf_counter()
        calls += 1
        done += len(out)
        if rng.random() < 1.0 / calls:
            kept = out
    r.end_window()
    window = t_last - t0
    r.e2e["tiles_s"] = done / window
    r.attempted = done
    r.stats.update(units=done, window_s=window, batches=calls * -(-len(pool) // bs),
                   model_flops=model_work.forward_flops(cfg, img, bs) / bs)
    r.read_peak()
    del model
    r.free()
    idx = np.sort(rng.choice(len(pool), tr["check_tiles"], replace=False))
    t1 = time.perf_counter()
    ref_u8, ref_f = reference_u8(cfg, pool[idx], r.seed, dev)
    nums = compare.served(kept[idx], ref_u8, ref_f)
    print(f"[numbers] {r.cell.name} seed {r.seed}: {tr['check_tiles']} tiles of call drawn "
          f"from {calls}: " + " ".join(f"{k} {v!r}" for k, v in nums.items())
          + f" (reference {time.perf_counter() - t1:.1f} s)", file=sys.stderr, flush=True)
    r.numbers = nums
    for name in r.cell.limits:
        r.check(name, nums[name], r.limit(name))
