"""K1 and K5 of the PyTorch port on one card, with the library's times beside them.

    python3 scripts/profile_attention_torch.py

Times, with CUDA events (median of 20 after 3 warm-up calls), at the shapes
the main path gives them:

  * K1 (``attention_bshd`` up to 512 tokens) in bf16 on the fused qkv
    buffer of 64 tiles (``[64, 329, 24 x 64]`` sections, read in place) and
    on the LoRA-live split layout, beside ``F.scaled_dot_product_attention``
    on the same tensors;
  * K5 (``flash_backward``) in bf16 at a 1024-px region (``[1, 5334, 24 x
    64]``) from K4's output and lse and a random output gradient, beside the
    library's attention backward alone (one forward kept, its gradient
    timed) and its forward plus backward.

Each line carries the least time the card could take for the kernel's work
(``chip_smoke.bound_ms``). The script uses only entry points that every
version of the port has, so that two trees can be timed in one call, in
turns. Prints the card's name and power limit first. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__} | tree {ROOT}", flush=True)
    from mipheivit_tpu_torch import _build
    from mipheivit_tpu_torch.ops import attention as attn

    for name in ("attention", "flash_attention", "flash_attention_bwd"):
        _build.build(name)
    dev, hd, bf16 = torch.device("cuda:0"), cs.HD, torch.bfloat16
    rng = np.random.default_rng(cs.SEED)

    qkv = torch.from_numpy(rng.standard_normal((cs.BATCH, 329, 3 * hd), dtype=np.float32)).to(
        dev, bf16)
    fused = (qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:])
    split = (fused[0].clone(),) + fused[1:]
    n_bytes = 4 * cs.BATCH * 329 * hd * 2
    bound, by = cs.bound_ms(n_bytes, 4.0 * cs.BATCH * cs.HEADS * 329 * 329 * 64, "bf16")
    with torch.inference_mode():
        for layout, (q, k, v) in (("fused", fused), ("split", split)):
            ms = cs.cuda_ms(lambda: attn.attention_bshd(q, k, v, cs.HEADS))
            lib = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                cs.heads_view(q), cs.heads_view(k), cs.heads_view(v)))
            print(f"[k1 bf16 {layout}] [{cs.BATCH}, 329, {hd}]: kernel {ms:.4f} ms, library "
                  f"(scaled_dot_product_attention) {lib:.4f} ms, bound {bound:.4f} ms ({by})",
                  flush=True)
    del qkv, fused, split

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
