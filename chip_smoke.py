"""Smoke run of the PyTorch port (mipheivit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 attention, K4 long-sequence flash
attention) from mipheivit_tpu_torch/csrc, holds each against its plain
PyTorch version at the shapes the paths give it, then drives the port's
paths at full width from a reference-layout MIPHEI-ViT checkpoint dir
(H-Optimus-0 ViT-g/14 encoder, 16 markers, random weights from a numpy
seed) -> load_generator(fast_heads=True) -> merge_lora -> cast_params(bf16):

  [slice]     predict_tiles on 150 uint8 256-px tiles at batch 64 (K1);
  [wsi 256]   wsi_inference over a synthetic 2048 x 2048 slide, 256-px
              windows, overlap 64, batch 64 (121 windows; K1);
  [wsi 1024]  the same with 1024-px region windows, overlap 128, batch 4
              (9 windows, S = 5334 tokens; K4).

It checks the outputs (the stitched slides against a serial reference
stitch), that every encoder block went through the kernel of its length,
and the full-width numerics against the CPU and between bf16 and f32. Each
phase prints one line with its seconds; any failure ends the run with a
non-zero exit. The last line is the device JSON.

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
KERNEL_TOL = {"bf16": 2e-2, "f32": 1e-4}
# K4's lse against the plain version: bf16 inputs, f32 inputs
LSE_TOL = {"bf16": 1e-3, "f32": 1e-5}
F32_CARD_VS_CPU_TOL = 2e-3
MIN_PEARSON = 0.99
SLIDE = 2048                     # synthetic slide side, px
HEADS, HD = 24, 24 * 64          # ViT-g attention
REGION_S = 73 * 73 + 5           # tokens of a 1024-px region window


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
        out_err = (out.float() - want_out.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        del out, lse, want_out, want_lse
        ms = cuda_ms(lambda: attn.flash_attention(q, k, v, HEADS, seq_len_k), reps=10)
        plain_ms = cuda_ms(lambda: attn.flash_reference(q, k, v, HEADS, seq_len_k),
                           reps=3, warmup=1)
    print(f"[k4 {name}] q {tuple(q.shape)} k {tuple(k.shape)} seq_len_k "
          f"{seq_len_k or k.shape[1]} out_err {out_err:.3e} (tol {KERNEL_TOL[dt]:g}) "
          f"lse_err {lse_err:.3e} (tol {LSE_TOL[dt]:g}) kernel {ms:.3f} ms "
          f"plain {plain_ms:.3f} ms ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(out_err <= KERNEL_TOL[dt] and lse_err <= LSE_TOL[dt],
          f"K4 {name} disagrees with the plain version")
    return out_err, lse_err, ms, plain_ms


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

    # 2. build K1 and K4 from the sources in the checkout, one nvcc each, at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_build.build, ("attention", "flash_attention")))
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
            kernel_rows[name] = (err, ms, plain_ms)
            print(f"[k1 {name}] shape {tuple(q.shape)} max_abs_err {err:.3e} "
                  f"(tol {KERNEL_TOL[kind_dt]:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms",
                  flush=True)
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

    # 8. summary lines
    err, ms, plain_ms = kernel_rows["bf16_fused"]
    k4_err, _, k4_ms, k4_plain_ms = k4_region
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "k1_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:563",
         "launches": launches + wsi256["attention"], "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms,
         "launches_by_path": {"slice": launches, "wsi 256": wsi256["attention"]}},
        {"name": "k4_flash_attention", "route": "cuda",
         "source": "mipheivit_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mipheivit_tpu/ops/attention.py:59",
         "launches": wsi1024["flash"], "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "launches_by_path": {"wsi 1024": wsi1024["flash"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
