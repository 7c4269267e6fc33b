"""Smoke run of the PyTorch port (mipheivit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel (K1 attention) from mipheivit_tpu_torch/csrc,
holds it against its plain PyTorch version at the flagship shapes, then
drives the flagship tile-inference path at full width: a reference-layout
MIPHEI-ViT checkpoint dir (H-Optimus-0 ViT-g/14 encoder, 16 markers, 256 px,
random weights from a numpy seed) -> load_generator(fast_heads=True) ->
merge_lora -> cast_params(bf16) -> predict_tiles on 150 uint8 tiles at batch
64. It checks the output, that every encoder block went through K1, and the
full-width numerics against the CPU. Each phase prints one line; any failure
ends the run with a non-zero exit. The last line is the device JSON.

Needs one CUDA card and nvcc; there is no CPU fallback.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 64
N_TILES = 150
IMG = 256
MARKERS = 16
SEED = 0
KERNEL_TOL = {"bf16": 2e-2, "f32": 1e-4}
F32_CARD_VS_CPU_TOL = 2e-3
MIN_PEARSON = 0.99


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


def load(ckpt, enc, device, dtype):
    from mipheivit_tpu_torch.infer import cast_params, load_generator, merge_lora

    model = load_generator("myvitmatte", "hoptimus0", ckpt, (IMG, IMG), MARKERS,
                           dtype=torch.float32, device=device,
                           encoder_ckpt_path=str(enc), fast_heads=True)
    return cast_params(merge_lora(model), dtype)


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

    # 2. build K1 from the sources in the checkout
    t0 = time.perf_counter()
    lib = _build.build("attention")
    print(f"[build] {lib.relative_to(Path(__file__).resolve().parent)} "
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

    # 6. summary lines
    err, ms, plain_ms = kernel_rows["bf16_fused"]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "k1_attention", "route": "cuda",
        "source": "mipheivit_tpu_torch/csrc/attention.cu",
        "replaces": "mipheivit_tpu/ops/attention.py:563",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
