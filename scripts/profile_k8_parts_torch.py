"""What the parts of K8's bf16 kernel cost, on one card.

    python3 scripts/profile_k8_parts_torch.py

Builds three versions of ``csrc/attn_block.cu`` into
``mipheivit_tpu_torch/build/k8_parts/`` and times each through
``ln_qkv_attention`` on x ``[64, 329, 1536]`` and ``[4, 1024, 1536]`` with
ViT-g's qkv weight (24 heads of 64), in turns (each version twice, in the
order a b c c b a), with CUDA events and the profiler's device time:

  kernel          the source as it is;
  no LN math      the x rows go to the products as they land, without the
                  LayerNorm's arithmetic in registers (the output is wrong);
  no attention    the projection alone: phase 2 skipped (no output).

"kernel" minus "no attention" is what the attention phase adds after the
projection (one block an SM runs the two in turn); "kernel" minus "no LN
math" what the normalisation in registers adds. Prints the card's name and
power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from scripts.profile_attention_torch import device_ms  # noqa: E402

LN_MATH = """            const int col2 = (kt * 64 + kk * 16 + tig * 2) / 2;
            const float2 g0 = __ldg(gamma + col2), b0 = __ldg(beta + col2);
            const float2 g1 = __ldg(gamma + col2 + 4), b1 = __ldg(beta + col2 + 4);
            af[kk][0] = ln_pair(raw[0], rs[0], nm[0], g0, b0);
            af[kk][1] = ln_pair(raw[1], rs[1], nm[1], g0, b0);
            af[kk][2] = ln_pair(raw[2], rs[0], nm[0], g1, b1);
            af[kk][3] = ln_pair(raw[3], rs[1], nm[1], g1, b1);
"""
ATTENTION = "    for (int tl = c; tl < live; tl += 2) {\n"


def versions(src: str) -> dict:
    for part in (LN_MATH, ATTENTION):
        if part not in src:
            raise RuntimeError(f"attn_block.cu no longer holds:\n{part}")
    return {"kernel": src,
            "no LN math": src.replace(LN_MATH, "".join(
                f"            af[kk][{i}] = raw[{i}];\n" for i in range(4))),
            "no attention": src.replace(ATTENTION, "    for (int tl = c; tl < 0; tl += 2) {\n")}


def main():
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__}", flush=True)
    from mipheivit_tpu_torch import _build
    from mipheivit_tpu_torch.ops import attn_block

    out_dir = _build.BUILD / "k8_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    srcs = versions((_build.CSRC / "attn_block.cu").read_text())

    def build(item):
        i, (name, src) = item
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(src)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{proc.stderr}")
        return name, so

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(pool.map(build, enumerate(srcs.items())))
    kernel_lib = attn_block._library()
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("k8_attn_block_bf16", "k8_attn_block_f32", "k8_error_string"):
            getattr(lib, fn).argtypes = getattr(kernel_lib, fn).argtypes
            getattr(lib, fn).restype = getattr(kernel_lib, fn).restype
        libs[name] = lib

    hd = cs.HD
    lns, lnb = cs.ln_params(hd, cs.SEED + 111)
    w = cs.seeded((3 * hd, hd), cs.SEED + 112, torch.bfloat16, hd ** -0.5)
    bias = cs.seeded(3 * hd, cs.SEED + 113, torch.bfloat16, 0.1)
    library = attn_block._library
    try:
        with torch.inference_mode():
            for b, s in ((cs.BATCH, 329), (4, 1024)):
                x = cs.seeded((b, s, hd), cs.SEED + 110, torch.bfloat16)
                times = {name: [] for name in libs}

                def run():
                    return attn_block.ln_qkv_attention(x, lns, lnb, w, bias, cs.HEADS)

                for name in list(libs) + list(libs)[::-1]:
                    attn_block._library = lambda n=name: libs[n]
                    times[name].append(f"{cs.cuda_ms(run):.4f} (device {device_ms(run):.4f})")
                print(f"[k8 parts] x [{b}, {s}, {hd}] bf16 ln_qkv_attention, ms (each version "
                      f"twice): " + "; ".join(f"{name} {', '.join(ts)}"
                                              for name, ts in times.items()), flush=True)
    finally:
        attn_block._library = library


if __name__ == "__main__":
    main()
