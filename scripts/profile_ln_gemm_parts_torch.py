"""What the parts of the LayerNorm kernels (K2's LN variant and K7) cost, on one card.

    python3 scripts/profile_ln_gemm_parts_torch.py

Builds four versions of ``csrc/swiglu.cu`` into
``mipheivit_tpu_torch/build/ln_gemm_parts/`` and times each through
``swiglu_fc1(..., ln=...)`` at ViT-g's fc1 (x ``[21056, 1536]``, packed w
``[8192, 1536]``) and ``ln_matmul`` at its qkv projection (w ``[4608,
1536]``), in turns (each version twice, in the order a b c d d c b a), with
CUDA events and the profiler's device time:

  kernel          the source as it is (A fragments normalised in registers,
                  wgmma RS, two fragment sets, one stage's products in
                  flight);
  one stage       the same with every stage's products retired before the
                  next stage is normalised (wgmma_wait<0>);
  no LN math      the x fragments go to the products as they are loaded
                  (ldmatrix, wgmma RS) without the LayerNorm's arithmetic
                  (the output is wrong);
  SS              the LN launches sent to the instances without the
                  LayerNorm (A read by wgmma from shared memory; the output
                  is wrong).

"kernel" minus "no LN math" is what the normalisation in registers adds,
"no LN math" minus "SS" what reading A into registers (ldmatrix, RS)
adds, "one stage" minus "kernel" what the second fragment set saves. The
row-statistics pre-pass runs in every version. Then each version runs
back to back for about two seconds while ``nvidia-smi`` samples the SM
clock and the power draw (the card holds its power limit by lowering the
clock, so arithmetic beside the products may cost clock rather than issue
slots). Prints the card's name and power limit first. Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from scripts.profile_attention_torch import device_ms  # noqa: E402

LN_MATH = """          const int col2 = (kt * TK + kk * 16 + tig * 2) / 2;
          const float2 g0 = __ldg(gamma + col2), b0 = __ldg(beta + col2);
          const float2 g1 = __ldg(gamma + col2 + 4), b1 = __ldg(beta + col2 + 4);
          af[kk][0] = ln_pair(xr[0], rs[0], nm[0], g0, b0);
          af[kk][1] = ln_pair(xr[1], rs[1], nm[1], g0, b0);
          af[kk][2] = ln_pair(xr[2], rs[0], nm[0], g1, b1);
          af[kk][3] = ln_pair(xr[3], rs[1], nm[1], g1, b1);
"""
WAIT = "      wgmma_wait<1>();  // the previous stage's products are done\n"
LN_LAUNCH = "    return gate ? launch_ws<true, true>(a, st) : launch_ws<true, false>(a, st);\n"


def versions(src: str) -> dict:
    for part in (LN_MATH, WAIT, LN_LAUNCH):
        if part not in src:
            raise RuntimeError(f"swiglu.cu no longer holds:\n{part}")
    return {"kernel": src,
            "one stage": src.replace(WAIT, "      wgmma_wait<0>();\n"),
            "no LN math": src.replace(LN_MATH, "".join(
                f"          af[kk][{i}] = xr[{i}];\n" for i in range(4))),
            "SS": src.replace(LN_LAUNCH, "    return gate ? launch_ws<false, true>(a, st) : "
                                         "launch_ws<false, false>(a, st);\n")}


def clock_and_power(run, seconds: float = 2.0) -> str:
    """``run`` back to back for about ``seconds`` while nvidia-smi samples
    the SM clock (MHz) and the power draw (W): their medians."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"]
    run()
    torch.cuda.synchronize()
    sampler = subprocess.Popen(query + ["-lms", "200"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
    finally:
        sampler.terminate()
        out, _ = sampler.communicate(timeout=30)
    rows = []
    for line in out.strip().splitlines()[1:]:  # the first sample may precede the load
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return "no samples"
    clock, power = np.median(np.array(rows), axis=0)
    return f"SM clock {clock:.0f} MHz, power {power:.0f} W ({len(rows)} samples)"


def main():
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__}", flush=True)
    from mipheivit_tpu_torch import _build
    from mipheivit_tpu_torch.ops import mlp

    out_dir = _build.BUILD / "ln_gemm_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    srcs = versions((_build.CSRC / "swiglu.cu").read_text())

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
    kernel_lib = mlp._library()
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("k2_swiglu_bf16", "k2_swiglu_f32", "k7_ln_matmul_bf16", "k7_ln_matmul_f32",
                   "k2_error_string"):
            getattr(lib, fn).argtypes = getattr(kernel_lib, fn).argtypes
            getattr(lib, fn).restype = getattr(kernel_lib, fn).restype
        libs[name] = lib

    m, k, h = cs.BATCH * 329, cs.FC1_K, cs.FC1_H
    rng = np.random.default_rng(cs.SEED + 44)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).cuda().bfloat16()
    w2 = cs.seeded((2 * h, k), cs.SEED + 45, torch.bfloat16, k ** -0.5)
    b2 = cs.seeded(2 * h, cs.SEED + 46, torch.bfloat16, 0.1)
    w7 = cs.seeded((3 * cs.HD, k), cs.SEED + 47, torch.bfloat16, k ** -0.5)
    b7 = cs.seeded(3 * cs.HD, cs.SEED + 48, torch.bfloat16, 0.1)
    lns, lnb = cs.ln_params(k, cs.SEED + 49)
    cases = {f"K2-LN x [{m}, {k}] w [{2 * h}, {k}]": lambda: mlp.swiglu_fc1(x, w2, b2,
                                                                          ln=(lns, lnb)),
             f"K7 x [{m}, {k}] w [{3 * cs.HD}, {k}]": lambda: mlp.ln_matmul(x, lns, lnb, w7, b7)}
    library = mlp._library
    try:
        with torch.inference_mode():
            for case, run in cases.items():
                times = {name: [] for name in libs}
                for name in list(libs) + list(libs)[::-1]:
                    mlp._library = lambda n=name: libs[n]
                    times[name].append(f"{cs.cuda_ms(run):.4f} (device {device_ms(run):.4f})")
                print(f"[ln gemm parts] {case} bf16, ms (each version twice): "
                      + "; ".join(f"{name} {', '.join(ts)}" for name, ts in times.items()),
                      flush=True)
                clocks = {}
                for name in libs:
                    mlp._library = lambda n=name: libs[n]
                    clocks[name] = clock_and_power(run)
                print(f"[ln gemm parts] {case} bf16, run back to back: "
                      + "; ".join(f"{name} {c}" for name, c in clocks.items()), flush=True)
    finally:
        mlp._library = library


if __name__ == "__main__":
    main()
