"""K1, K4, K5, K2, K6, K7, K8 and K3 of the PyTorch port on one card, beside the library's times.

    python3 scripts/profile_attention_torch.py [--only k1 k5 k4 k2 k2ln k6 k7 k8 k3]

Times, with CUDA events (median of 20 after 3 warm-up calls), at the shapes
the main path gives them:

  * K1 (``attention_bshd`` up to 512 tokens) in bf16 on the fused qkv
    buffer of 64 tiles (``[64, 329, 24 x 64]`` sections, read in place) and
    on the LoRA-live split layout, beside ``F.scaled_dot_product_attention``
    on the same tensors;
  * K5 (``flash_backward``) in bf16 at a 1024-px region (``[1, 5334, 24 x
    64]``) from K4's output and lse and a random output gradient, beside the
    library's attention backward alone (one forward kept, its gradient
    timed) and its forward plus backward;
  * K4 (``flash_attention``) in bf16 at a pair of 1024-px regions (``[2,
    5334, 24 x 64]`` sections of one fused buffer; 5334 = 41 x 128 + 86), a
    sequence shard's rectangle (1334 q rows over the 5334 keys, and over
    5376 keys of which 5334 are live, the padding NaN and Inf) and S = 513,
    beside ``F.scaled_dot_product_attention`` on the live keys;
  * K2 (``swiglu_fc1`` without LayerNorm) in bf16 at ViT-g's fc1 (K 1536, H
    4096) for M = 21056 (64 tiles), 10528 (the daemon's 32), 5334 (a 1024-px
    training microbatch), 2632 (a 256-px one), 658 and 1, and at H and K
    tails (M 330, K 200, H 520), beside the library's packed GEMM plus gate
    (``F.linear``, ``F.silu(a) * g``) and the GEMM alone; and its LayerNorm
    variant (``swiglu_fc1(..., ln=...)``, off every model path) at M 21056
    beside ``F.layer_norm`` + the same GEMM and gate;
  * K7 (``ln_matmul``) in bf16 at ViT-g's qkv projection (K 1536, N 4608)
    for M = 21056 (64 tiles) and 658 (two tiles), beside ``F.layer_norm`` +
    ``F.linear`` on the same tensors;
  * K6 (``dot_product_attention`` up to 512 tokens) in bf16 on q, k, v
    ``[64, 24, 329, 64]`` and ``[64, 24, 77, 64]``, beside
    ``F.scaled_dot_product_attention`` on the same tensors;
  * K8 (``ln_qkv_attention``) in bf16 on x ``[64, 329, 1536]`` and ``[4,
    1024, 1536]`` with ViT-g's qkv weight (24 heads of 64), beside
    ``F.layer_norm`` + ``F.linear`` + ``F.scaled_dot_product_attention`` and
    beside the model's own route, ``F.layer_norm`` + ``F.linear`` +
    ``attention_qkv`` (K1 at 329 tokens, K4 at 1024);
  * K3 (``fused_seg_heads``) in bf16 on the decoder's last map [B, 32, H, W]
    at the serving paths' shapes (64 and 32 tiles of 256 px, 4 regions of
    1024 px, 16 markers) and a 19-marker panel on 64 tiles, beside its plain
    version and the module's cuDNN eval chain (``BatchedSegHeads.chain``); a
    tree whose K3 takes 16 heads at most says so.

The K4, K2, K6, K7, K8 and K3 lines give each time twice: CUDA events around one
call (host launch work counts where the card waits for it), and the device
time of the call's kernels in a ``torch.profiler`` trace of 10 calls
(``device``).

Each line carries the least time the card could take for the kernel's work
(``chip_smoke.bound_ms``). The script uses only entry points that every
version of the port has, so that two trees can be timed in one call, in
turns. Prints the card's name and power limit first. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


device_ms = cs.device_ms


def k4_rows(dev):
    from mipheivit_tpu_torch.ops import attention as attn

    hd, bf16 = cs.HD, torch.bfloat16

    def fused(b, s, seed):
        t = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (b, s, 3 * hd), dtype=np.float32)).to(dev, bf16)
        return t[..., :hd], t[..., hd:2 * hd], t[..., 2 * hd:]

    q, k, v = fused(2, cs.REGION_S, cs.SEED + 10)
    _, kp, vp = fused(2, 5376, cs.SEED + 11)
    kp[:, :cs.REGION_S], vp[:, :cs.REGION_S] = k, v
    kp[:, cs.REGION_S:], vp[:, cs.REGION_S:] = float("nan"), float("inf")
    cases = {"region [2, 5334]": (q, k, v, None), "cross [2, 1334 x 5334]": (q[:, :1334], k, v, None),
             "cross padded NaN [2, 1334 x 5376, 5334 live]": (q[:, :1334], kp, vp, cs.REGION_S),
             "S 513 [2, 513]": fused(2, 513, cs.SEED + 513) + (None,)}
    with torch.inference_mode():
        for name, (q, k, v, live) in cases.items():
            n = live or k.shape[1]
            kl, vl = k[:, :n], v[:, :n]

            def run():
                return attn.flash_attention(q, k, v, cs.HEADS, live)

            ms, dms = cs.cuda_ms(run), device_ms(run)
            lib = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                cs.heads_view(q), cs.heads_view(kl), cs.heads_view(vl)))
            b, sq, _ = q.shape
            bound, by = cs.bound_ms((2 * b * sq + 2 * b * n) * hd * 2 + b * cs.HEADS * sq * 4,
                                    4.0 * b * cs.HEADS * sq * n * 64, "bf16")
            print(f"[k4 bf16 {name}]: kernel {ms:.4f} ms (device {dms:.4f} ms), library "
                  f"(scaled_dot_product_attention) {lib:.4f} ms, bound {bound:.4f} ms ({by})",
                  flush=True)


def k2_rows(dev):
    from mipheivit_tpu_torch.ops import mlp

    shapes = [(21056, cs.FC1_K, cs.FC1_H), (10528, cs.FC1_K, cs.FC1_H),
              (5334, cs.FC1_K, cs.FC1_H), (2632, cs.FC1_K, cs.FC1_H), (658, cs.FC1_K, cs.FC1_H),
              (1, cs.FC1_K, cs.FC1_H), (330, 200, 520)]
    with torch.inference_mode():
        for m, k, h in shapes:
            rng = np.random.default_rng(cs.SEED + m)
            x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(
                dev, torch.bfloat16)
            w = torch.from_numpy(rng.standard_normal((2 * h, k), dtype=np.float32)
                                 / np.float32(k ** 0.5)).to(dev, torch.bfloat16)
            b = torch.from_numpy(rng.standard_normal(2 * h, dtype=np.float32)
                                 * np.float32(0.1)).to(dev, torch.bfloat16)

            def run():
                return mlp.swiglu_fc1(x, w, b)

            def library():
                ag = F.linear(x, w, b)
                return F.silu(ag[:, :h]) * ag[:, h:]

            ms, dms = cs.cuda_ms(run), device_ms(run)
            lib, lib_d = cs.cuda_ms(library), device_ms(library)
            gemm = cs.cuda_ms(lambda: F.linear(x, w, b))
            bound, by = cs.bound_ms((m * k + 2 * h * k + 2 * h + m * h) * 2, 2.0 * m * k * 2 * h,
                                    "bf16")
            print(f"[k2 bf16 M {m} K {k} H {h}]: kernel {ms:.4f} ms (device {dms:.4f} ms), "
                  f"library GEMM + gate {lib:.4f} ms (device {lib_d:.4f} ms), GEMM alone "
                  f"{gemm:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)


def k2ln_rows(dev):
    from mipheivit_tpu_torch.ops import mlp

    m, k, h = 21056, cs.FC1_K, cs.FC1_H
    rng = np.random.default_rng(cs.SEED + 44)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((2 * h, k), dtype=np.float32)
                         / np.float32(k ** 0.5)).to(dev, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(2 * h, dtype=np.float32)
                         * np.float32(0.1)).to(dev, torch.bfloat16)
    lns, lnb = cs.ln_params(k, cs.SEED + 45, dev)
    lns_t, lnb_t = lns.bfloat16(), lnb.bfloat16()

    def run():
        return mlp.swiglu_fc1(x, w, b, ln=(lns, lnb))

    def library():
        ag = F.linear(F.layer_norm(x, (k,), lns_t, lnb_t, 1e-6), w, b)
        return F.silu(ag[:, :h]) * ag[:, h:]

    with torch.inference_mode():
        ms, dms = cs.cuda_ms(run), device_ms(run)
        lib, lib_d = cs.cuda_ms(library), device_ms(library)
    bound, by = cs.bound_ms((m * k + 2 * h * k + 2 * h + m * h) * 2 + 2 * k * 4,
                            2.0 * m * k * 2 * h, "bf16")
    print(f"[k2 ln bf16 M {m} K {k} H {h}]: kernel {ms:.4f} ms (device {dms:.4f} ms), library "
          f"LN + GEMM + gate {lib:.4f} ms (device {lib_d:.4f} ms), bound {bound:.4f} ms ({by})",
          flush=True)


def k7_rows(dev):
    from mipheivit_tpu_torch.ops import mlp

    hd = cs.HD
    lns, lnb = cs.ln_params(hd, cs.SEED + 101, dev)
    w = cs.seeded((3 * hd, hd), cs.SEED + 102, torch.bfloat16, hd ** -0.5, device=dev)
    b = cs.seeded(3 * hd, cs.SEED + 103, torch.bfloat16, 0.1, device=dev)
    lns_t, lnb_t = lns.bfloat16(), lnb.bfloat16()
    with torch.inference_mode():
        for m in (cs.BATCH * 329, 2 * 329):
            x = cs.seeded((m, hd), cs.SEED + 100, torch.bfloat16, device=dev)

            def run():
                return mlp.ln_matmul(x, lns, lnb, w, b)

            def library():
                return F.linear(F.layer_norm(x, (hd,), lns_t, lnb_t, 1e-6), w, b)

            ms, dms = cs.cuda_ms(run), device_ms(run)
            lib, lib_d = cs.cuda_ms(library), device_ms(library)
            bound, by = cs.bound_ms((m * hd + 3 * hd * hd + 3 * hd + m * 3 * hd) * 2 + 2 * hd * 4,
                                    2.0 * m * hd * 3 * hd, "bf16")
            print(f"[k7 bf16 M {m} K {hd} N {3 * hd}]: kernel {ms:.4f} ms (device {dms:.4f} ms), "
                  f"library (layer_norm + linear) {lib:.4f} ms (device {lib_d:.4f} ms), bound "
                  f"{bound:.4f} ms ({by})", flush=True)


def k6_rows(dev):
    from mipheivit_tpu_torch.ops import attention as attn

    with torch.inference_mode():
        for b, s in ((cs.BATCH, 329), (cs.BATCH, 77)):
            q, k, v = (cs.seeded((b, cs.HEADS, s, 64), cs.SEED + 70 + i, torch.bfloat16, device=dev)
                       for i in range(3))

            def run():
                return attn.dot_product_attention(q, k, v)

            def library():
                return F.scaled_dot_product_attention(q, k, v)

            ms, dms = cs.cuda_ms(run), device_ms(run)
            lib, lib_d = cs.cuda_ms(library), device_ms(library)
            bound, by = cs.bound_ms(4 * b * cs.HEADS * s * 64 * 2,
                                    4.0 * b * cs.HEADS * s * s * 64, "bf16")
            print(f"[k6 bf16 [{b}, {cs.HEADS}, {s}, 64]]: kernel {ms:.4f} ms (device {dms:.4f} ms), "
                  f"library (scaled_dot_product_attention) {lib:.4f} ms (device {lib_d:.4f} ms), "
                  f"bound {bound:.4f} ms ({by})", flush=True)


def k8_rows(dev):
    from mipheivit_tpu_torch.ops import attn_block
    from mipheivit_tpu_torch.ops.attention import attention_qkv

    hd, heads = cs.HD, cs.HEADS
    lns, lnb = cs.ln_params(hd, cs.SEED + 111, dev)
    w = cs.seeded((3 * hd, hd), cs.SEED + 112, torch.bfloat16, hd ** -0.5, device=dev)
    bias = cs.seeded(3 * hd, cs.SEED + 113, torch.bfloat16, 0.1, device=dev)
    lns_t, lnb_t = lns.bfloat16(), lnb.bfloat16()
    with torch.inference_mode():
        for b, s in ((cs.BATCH, 329), (4, 1024)):
            x = cs.seeded((b, s, hd), cs.SEED + 110, torch.bfloat16, device=dev)

            def run():
                return attn_block.ln_qkv_attention(x, lns, lnb, w, bias, heads)

            def qkv():
                return F.linear(F.layer_norm(x, (hd,), lns_t, lnb_t, 1e-6), w, bias)

            def library():
                q, k, v = (t.view(b, s, heads, 64).transpose(1, 2) for t in qkv().split(hd, -1))
                return F.scaled_dot_product_attention(q, k, v)

            def model_route():
                return attention_qkv(qkv(), heads)

            ms, dms = cs.cuda_ms(run), device_ms(run)
            lib, lib_d = cs.cuda_ms(library), device_ms(library)
            route, route_d = cs.cuda_ms(model_route), device_ms(model_route)
            bound, by = cs.bound_ms((2 * b * s * hd + 3 * hd * hd + 3 * hd) * 2 + 2 * hd * 4,
                                    2.0 * b * s * hd * 3 * hd + 4.0 * b * heads * s * s * 64,
                                    "bf16")
            print(f"[k8 bf16 [{b}, {s}, {hd}]]: kernel {ms:.4f} ms (device {dms:.4f} ms), "
                  f"library "
                  f"(layer_norm + linear + scaled_dot_product_attention) {lib:.4f} ms (device "
                  f"{lib_d:.4f} ms), model route (layer_norm + linear + attention_qkv) {route:.4f} "
                  f"ms (device {route_d:.4f} ms), bound {bound:.4f} ms ({by})", flush=True)


def k3_rows(dev):
    from mipheivit_tpu_torch.ops import seg_heads

    cases = (("tiles", cs.BATCH, cs.IMG, cs.MARKERS), ("serve", cs.SERVE_BATCH, cs.IMG, cs.MARKERS),
             ("regions", 4, cs.REGION, cs.MARKERS), ("panel19", cs.BATCH, cs.IMG, 19))
    # a tree whose K3 takes 16 heads at most has a smoke script with 16-marker
    # heads and their operation count only
    flops_per_px = getattr(cs, "head_flops_per_px", lambda k: cs.HEAD_FLOPS_PER_PX)
    with torch.inference_mode():
        for name, b, side, k in cases:
            tag = f"[k3 bf16 {name} [{b}, {cs.HEAD_C}, {side}, {side}] K {k}]"
            try:
                heads = cs.seeded_heads(cs.SEED + 50, dev, *([k] if k != cs.MARKERS else []))
            except TypeError:
                print(f"{tag}: not run (this tree's K3 takes 16 heads at most)", flush=True)
                continue
            heads = heads.to(torch.bfloat16)
            weights = seg_heads.fold_heads(heads, torch.bfloat16)
            x = cs.seeded((b, side, side, cs.HEAD_C), cs.SEED + 51, torch.bfloat16,
                          device=dev).permute(0, 3, 1, 2)

            def run():
                return seg_heads.fused_seg_heads(x, *weights)

            def plain():
                return seg_heads.seg_heads_reference(x, *weights)

            def library():
                return heads.chain(x)

            ms, dms = cs.cuda_ms(run), device_ms(run)
            plain_ms = cs.cuda_ms(plain, reps=3, warmup=1)
            lib, lib_d = cs.cuda_ms(library, reps=5, warmup=1), device_ms(library, reps=3)
            n_px = b * side * side
            bound, by = cs.bound_ms(n_px * (cs.HEAD_C + k) * 2, 1.0 * n_px * flops_per_px(k),
                                    "bf16")
            print(f"{tag}: kernel {ms:.4f} ms "
                  f"(device {dms:.4f} ms), plain {plain_ms:.4f} ms, library (cuDNN eval chain) "
                  f"{lib:.4f} ms (device {lib_d:.4f} ms), bound {bound:.4f} ms ({by})",
                  flush=True)
            del x, heads, weights
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*",
                    default=["k1", "k5", "k4", "k2", "k2ln", "k6", "k7", "k8", "k3"])
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__} | tree {ROOT}", flush=True)
    from mipheivit_tpu_torch import _build
    from mipheivit_tpu_torch.ops import attention as attn

    for name in ("attention", "flash_attention", "flash_attention_bwd", "swiglu", "attn_block",
                 "seg_heads"):
        _build.build(name)
    dev, hd, bf16 = torch.device("cuda:0"), cs.HD, torch.bfloat16
    rows = {"k4": k4_rows, "k2": k2_rows, "k2ln": k2ln_rows, "k6": k6_rows, "k7": k7_rows,
            "k8": k8_rows, "k3": k3_rows}
    for name, fn in rows.items():
        if name in args.only:
            fn(dev)
    rng = np.random.default_rng(cs.SEED)

    qkv = torch.from_numpy(rng.standard_normal((cs.BATCH, 329, 3 * hd), dtype=np.float32)).to(
        dev, bf16)
    fused = (qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:])
    split = (fused[0].clone(),) + fused[1:]
    n_bytes = 4 * cs.BATCH * 329 * hd * 2
    bound, by = cs.bound_ms(n_bytes, 4.0 * cs.BATCH * cs.HEADS * 329 * 329 * 64, "bf16")
    with torch.inference_mode():
        for layout, (q, k, v) in (("fused", fused), ("split", split)) if "k1" in args.only else ():
            ms = cs.cuda_ms(lambda: attn.attention_bshd(q, k, v, cs.HEADS))
            lib = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                cs.heads_view(q), cs.heads_view(k), cs.heads_view(v)))
            print(f"[k1 bf16 {layout}] [{cs.BATCH}, 329, {hd}]: kernel {ms:.4f} ms, library "
                  f"(scaled_dot_product_attention) {lib:.4f} ms, bound {bound:.4f} ms ({by})",
                  flush=True)
    del qkv, fused, split
    if "k5" not in args.only:
        return

    t = torch.from_numpy(rng.standard_normal((1, cs.REGION_S, 3 * hd), dtype=np.float32)).to(
        dev, bf16)
    q, k, v = t[..., :hd], t[..., hd:2 * hd], t[..., 2 * hd:]
    g = torch.from_numpy(rng.standard_normal((1, cs.REGION_S, hd), dtype=np.float32)).to(dev, bf16)
    with torch.no_grad():
        out, lse = attn.flash_attention(q, k, v, cs.HEADS)
        ms = cs.cuda_ms(lambda: attn.flash_backward(q, k, v, out, lse, g, cs.HEADS))
    ql, kl, vl = (cs.heads_view(x, True) for x in (q, k, v))
    gl = cs.heads_view(g)
    o = F.scaled_dot_product_attention(ql, kl, vl)
    bwd = cs.cuda_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), gl, retain_graph=True))

    def fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), gl)

    both = cs.cuda_ms(fwd_bwd)
    s = cs.REGION_S
    bound, by = cs.bound_ms(8 * s * hd * 2 + cs.HEADS * s * 4,
                            10.0 * cs.HEADS * s * s * 64, "bf16")
    print(f"[k5 bf16 region] [1, {s}, {hd}]: kernel {ms:.4f} ms, library backward alone "
          f"{bwd:.4f} ms, forward + backward {both:.4f} ms, bound {bound:.4f} ms ({by})",
          flush=True)


if __name__ == "__main__":
    main()
