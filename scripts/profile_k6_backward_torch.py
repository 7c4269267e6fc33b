"""Where tests/test_torch_short_attention.py::test_backward_on_card_matches_cpu
loses its margin: the f32 attention backward of dot_product_attention (K6's
forward, the plain recompute backward) on the card against the CPU.

    python3 scripts/profile_k6_backward_torch.py [--files tests/test_torch_*.py ...]

For a fresh process, after each given ``gpu`` test file has run in the
same process (``pytest -m gpu --noconftest``, in a subprocess of its own),
and after all of them have run in one process, in the order given (as a
whole ``gpu`` run does), computes the test's gradients five times on the
card and five times on the CPU and prints, per gradient: how far the runs
differ from each other and from the fresh process's results (bit for bit
or not), on each side, and the worst ratio of ``|card - cpu|`` to the
test's allowance ``atol + rtol * |cpu|`` (above 1: the test fails), with
the element where it falls. Prints the card's name and power limit first.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ATOL, RTOL = 1e-5, 1e-4       # the test's allowance


def grads(dev):
    """The test's computation: q, k, v [2, 2, 100, 64] f32 from seed 10, the
    output weighted by r (seed 11), gradients of q, k, v on ``dev``."""
    from mipheivit_tpu_torch.ops import attention as port

    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn((2, 2, 100, 64), generator=g) for _ in range(3))
    r = torch.randn((2, 2, 100, 64), generator=torch.Generator().manual_seed(11))
    ts = [t.to(dev).requires_grad_() for t in (q, k, v)]
    (port.dot_product_attention(*ts) * r.to(dev)).sum().backward()
    return [t.grad.cpu() for t in ts]


def spread(runs, ref):
    """(largest difference between the runs, largest difference of the
    first from ``ref``)."""
    return (max((a - runs[0]).abs().max().item() for a in runs),
            (runs[0] - ref).abs().max().item() if ref is not None else 0.0)


def report(tag, res, fresh):
    lines = []
    for i, name in enumerate(("dq", "dk", "dv")):
        card, cpu = [c[i] for c in res["card"]], [c[i] for c in res["cpu"]]
        card_s, card_f = spread(card, fresh and fresh["card"][0][i])
        cpu_s, cpu_f = spread(cpu, fresh and fresh["cpu"][0][i])
        ratio = max(((a - c).abs() / (ATOL + RTOL * c.abs()) for a in card for c in cpu),
                    key=lambda t: t.max().item())
        where = tuple(int(x) for x in torch.nonzero(ratio == ratio.max())[0])
        lines.append(f"{name}: card spread {card_s:.3e} vs fresh {card_f:.3e}, cpu spread "
                     f"{cpu_s:.3e} vs fresh {cpu_f:.3e}, worst |card-cpu|/allowance "
                     f"{ratio.max().item():.3f} at {where} (card {card[0][where]:.7e}, cpu "
                     f"{cpu[0][where]:.7e})")
    print(f"[{tag}] " + "; ".join(lines), flush=True)


def child(out, files):
    """In a subprocess: run the test files (if any) in this process, then
    the gradients, five times on each side; save them to ``out`` for the
    parent."""
    if files:
        import pytest

        pytest.main([*files, "-m", "gpu", "--noconftest", "-q", "-p", "no:cacheprovider"])
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": [grads(cuda) for _ in range(5)], "cpu": [grads("cpu") for _ in range(5)]}
    torch.save(res, out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", nargs="*", default=[])
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.files)
        return
    import chip_smoke as cs

    cs.check(torch.cuda.is_available(), "no CUDA device; this script runs only on the card")
    print(f"[device] {cs.card_line()} | torch {torch.__version__}", flush=True)
    fresh = None
    runs = [("fresh process", [])] + [(f"after {f}", [f]) for f in args.files]
    if len(args.files) > 1:
        runs.append(("after all files in one process", args.files))
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, files) in enumerate(runs):
            out = str(Path(tmp) / f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--child", out, "--files", *files],
                           check=True, cwd=ROOT, stdout=subprocess.DEVNULL)
            res = torch.load(out)
            report(tag, res, fresh)
            fresh = res if fresh is None else fresh


if __name__ == "__main__":
    main()
