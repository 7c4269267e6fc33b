"""What the parts of K5's bf16 kernel cost, on one card.

    python3 scripts/profile_k5_parts_torch.py

Builds three versions of ``csrc/flash_attention_bwd.cu`` into
``mipheivit_tpu_torch/build/k5_parts/`` and times each at a 1024-px region
(``[1, 5334, 24 x 64]`` bf16, from K4's output and lse and a random output
gradient) through ``flash_backward``, in turns (each version twice, in the
order a b c c b a), with CUDA events:

  kernel          the source as it is;
  no dQ sum       without the TMA bulk reduce-add of each dQ tile into the
                  f32 buffer (dq comes out wrong);
  no dQ           without the dQ product either: what the four products of
                  the dK / dV warpgroups take alone.

The differences price the design's choices: the dQ sum is the traffic a
one-kernel backward adds, and half of "no dQ" (two of its four products,
S^T and dP^T) is about what a separate dQ kernel would recompute instead.
Prints the card's name and power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SUM = """        for (int bx = 0; bx < D / 32; ++bx)
          tma_reduce_add_3d(&dqmap, buf + bx * P::DQ_BOX, h * D + 32 * bx, i * BQ, b);
"""
PRODUCT = """          wgmma_ss_n64<1, 1>(dq[hh], smem_desc(dsb + kk * 2048),
                             smem_desc(k_s + (kk / 4) * TILE_BYTES + hh * HALF + (kk % 4) * 2048),
                             kk);"""


def versions(src: str) -> dict:
    for part in (SUM, PRODUCT):
        if part not in src:
            raise RuntimeError(f"flash_attention_bwd.cu no longer holds:\n{part}")
    no_sum = src.replace(SUM, "")
    return {"kernel": src, "no dQ sum": no_sum,
            "no dQ": no_sum.replace(
                PRODUCT, "          for (int e = 0; e < 4; ++e) dq[hh][4 * (kk % 8) + e] = 0.f;")}


def main():
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__}", flush=True)
    from mipheivit_tpu_torch import _build
    from mipheivit_tpu_torch.ops import attention as attn

    out_dir = _build.BUILD / "k5_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    srcs = versions((_build.CSRC / "flash_attention_bwd.cu").read_text())

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
    argtypes = attn._flash_bwd_library().k5_flash_bwd_bf16.argtypes
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        lib.k5_flash_bwd_bf16.argtypes = argtypes
        lib.k5_flash_bwd_bf16.restype = ctypes.c_int
        lib.k5_error_string.argtypes = [ctypes.c_int]
        lib.k5_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    rng = np.random.default_rng(cs.SEED)
    hd, s = cs.HD, cs.REGION_S
    t = torch.from_numpy(rng.standard_normal((1, s, 3 * hd), dtype=np.float32)).cuda().bfloat16()
    g = torch.from_numpy(rng.standard_normal((1, s, hd), dtype=np.float32)).cuda().bfloat16()
    q, k, v = t[..., :hd], t[..., hd:2 * hd], t[..., 2 * hd:]
    times = {name: [] for name in libs}
    kernel_lib = attn._flash_bwd_library
    try:
        with torch.no_grad():
            out, lse = attn.flash_attention(q, k, v, cs.HEADS)
            for name in list(libs) + list(libs)[::-1]:
                attn._flash_bwd_library = lambda n=name: libs[n]
                times[name].append(cs.cuda_ms(
                    lambda: attn.flash_backward(q, k, v, out, lse, g, cs.HEADS)))
    finally:
        attn._flash_bwd_library = kernel_lib
    print("[k5 parts] [1, 5334, 1536] bf16 flash_backward, ms (each version twice): "
          + "; ".join(f"{name} {', '.join(f'{x:.4f}' for x in ts)}" for name, ts in times.items()),
          flush=True)


if __name__ == "__main__":
    main()
