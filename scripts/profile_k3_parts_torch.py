"""What the parts of K3's bf16 kernel cost, on one card.

    python3 scripts/profile_k3_parts_torch.py [--ptxas]

Builds versions of ``csrc/seg_heads.cu`` into
``mipheivit_tpu_torch/build/k3_parts/`` and times each through
``fused_seg_heads`` on the decoder's last map of 64 tiles ([64, 32, 256,
256]) and of 4 regions ([4, 32, 1024, 1024]) at 16 markers, and of 64
tiles at 19 (one pass of 24 heads, rows by 16-byte vector stores), in
turns (each version twice, in the order a b c ... c b a), with CUDA events
and the profiler's device time:

  kernel            the source as it is;
  no psi            psi-conv2's products skipped: the gates are sigmoid(b2)
                    (the output is wrong);
  no g1             g1's products skipped: g1 is b1 (the output is wrong);
  no taps           the tap products and sums skipped (the output is wrong);
  no gates          the gate products skipped (the output is wrong);
  loads only        both skipped: the loads, the barriers and the stores.

"kernel" minus "no taps" is what the taps add, minus "no gates" what the
gates add; "loads only" is the floor of the pipeline around them. With
``--ptxas`` prints each version's registers and spills. Prints the card's
name and power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
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
from scripts.profile_attention_torch import device_ms  # noqa: E402

PSI_MMA = """      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HG; ++k)
        wgmma_rs_n8<0>(gp, pa[k], smem_desc64(w2_s + ((p * HG + k) * NC2 + jc) * W2_TILE), 1);
      wgmma_commit();
      wgmma_wait<0>();
"""
G1 = """#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        wgmma_rs_n128<0>(acc, a[kk], desc_cw<CW>(w1_s + (p * NC2 + jc) * L::W1_TILE + 32 * kk), 1);
"""
TAPS = ("taps_issue<CW>(tm[", "taps_sum(tm[")
GATES = ("pass_gates<PG, CW, NC2>(af[1], ", "pass_gates<PG, CW, NC2>(ae, ")


def versions(src: str) -> dict:
    for part in (PSI_MMA, G1) + TAPS + GATES:
        if part not in src:
            raise RuntimeError(f"seg_heads.cu no longer holds:\n{part}")

    def skip(text, parts):
        for part in parts:
            text = text.replace(part, "if (false) " + part)
        return text

    return {"kernel": src, "no psi": src.replace(PSI_MMA, ""), "no g1": src.replace(G1, ""),
            "no taps": skip(src, TAPS), "no gates": skip(src, GATES),
            "loads only": skip(src, TAPS + GATES)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__}", flush=True)
    from mipheivit_tpu_torch import _build
    from mipheivit_tpu_torch.ops import seg_heads

    out_dir = _build.BUILD / "k3_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    srcs = versions((_build.CSRC / "seg_heads.cu").read_text())
    flags = ["-Xptxas", "-v"] if args.ptxas else []

    def build(item):
        i, (name, src) = item
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(src)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{proc.stderr}")
        if args.ptxas:  # each bf16 instantiation's registers and spills (PG: groups a pass)
            entry, notes = None, {}
            for ln in proc.stderr.splitlines():
                if "Compiling entry function" in ln:
                    # the template arguments <PG, CW, NC2>, e.g. "Li2ELi32ELi1E"
                    entry = (ln.split("heads_ws_kernelI")[1].split("EEv")[0]
                             if "heads_ws_kernel" in ln else None)
                elif entry and ("Used" in ln or "spill" in ln or "C75" in ln):
                    notes.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
            print(f"[k3 parts ptxas] {name}: " + "; ".join(
                f"<{args}>: {' | '.join(ns)}" for args, ns in sorted(notes.items())), flush=True)
        return name, so

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(pool.map(build, enumerate(srcs.items())))
    kernel_lib = seg_heads._library()
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("k3_seg_heads_bf16", "k3_seg_heads_f32", "k3_error_string"):
            getattr(lib, fn).argtypes = getattr(kernel_lib, fn).argtypes
            getattr(lib, fn).restype = getattr(kernel_lib, fn).restype
        libs[name] = lib

    dev = torch.device("cuda:0")
    library = seg_heads._library
    try:
        with torch.inference_mode():
            for b, side, k in ((cs.BATCH, cs.IMG, cs.MARKERS), (4, cs.REGION, cs.MARKERS),
                               (cs.BATCH, cs.IMG, 19)):
                heads = cs.seeded_heads(cs.SEED + 50, dev, k).to(torch.bfloat16)
                weights = seg_heads.fold_heads(heads, torch.bfloat16)
                x = torch.from_numpy(np.random.default_rng(cs.SEED + 51).standard_normal(
                    (b, side, side, cs.HEAD_C), dtype=np.float32)).to(dev, torch.bfloat16)
                x = x.permute(0, 3, 1, 2)
                want = seg_heads.seg_heads_reference(x, *weights).float()
                times = {name: [] for name in libs}

                def run():
                    return seg_heads.fused_seg_heads(x, *weights)

                for name in list(libs) + list(libs)[::-1]:
                    seg_heads._library = lambda n=name: libs[n]
                    err = ((run().float() - want).abs().max() / want.abs().max()).item()
                    times[name].append(f"{cs.cuda_ms(run):.4f} (device {device_ms(run):.4f}, "
                                       f"err {err:.1e})")
                print(f"[k3 parts] x [{b}, {cs.HEAD_C}, {side}, {side}] bf16, K {k}, "
                      f"fused_seg_heads, ms (each version twice; max err scaled to the "
                      f"reference): "
                      + "; ".join(f"{name} {', '.join(ts)}" for name, ts in times.items()),
                      flush=True)
                del x, want
                torch.cuda.empty_cache()
    finally:
        seg_heads._library = library


if __name__ == "__main__":
    main()
