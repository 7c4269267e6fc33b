"""The numbers that decide ``correct``.

Served outputs (uint8 marker maps) against the reference's, on the same
pixels: ``mean_abs`` is the mean absolute difference in uint8 steps;
``rel_rms`` the RMS difference of the program's values from the
reference's before the cast, over the reference's spread (its standard
deviation); ``far_share`` the share of values more than 4 steps off;
``max_abs`` the widest difference.

Training: ``loss_gap`` is the largest relative difference of a
microbatch's loss; ``grad_gap`` and ``change_gap`` are, for the first
step's clipped gradient and for the tensors' change after the compared
steps, the largest gap between the program's and the reference's norm of
one tensor, over the larger of that tensor's reference norm and the median
tensor's; ``grad_gap_median``, ``grad_gap_p90`` and ``change_gap_median`` the
median and 90th-percentile tensor's gap (the worst tensor is one small LoRA
adapter, whose gap swings from seed to seed); ``lora_grad_cos_gap`` is 1
less the cosine of the whole LoRA gradient, all adapters in one vector.
Tensors whose reference gradient is under a thousandth of the median
tensor's are left out of ``change_gap``: Adam moves them by round-off
alone.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def served(got_u8: np.ndarray, ref_u8: np.ndarray, ref_f: np.ndarray) -> Dict[str, float]:
    g = got_u8.astype(np.float64)
    diff = np.abs(g - ref_u8.astype(np.float64))
    spread = float(ref_f.std()) or 1.0
    return {"mean_abs": float(diff.mean()),
            "rel_rms": float(np.sqrt(np.mean((g - ref_u8) ** 2)) / spread),
            "far_share": float(np.mean(diff > 4)),
            "max_abs": float(diff.max())}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def norm_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep=None):
    """Each tensor's gap of norms."""
    g, w = _norms(got), _norms(want)
    names = [n for n in w if keep is None or keep(n)]
    median = float(np.median([w[n] for n in names])) or 1.0
    return {n: abs(g[n] - w[n]) / max(w[n], median) for n in names}


def training(got: dict, want: dict) -> Dict[str, float]:
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    gn = _norms(want["first_grad"])
    median = float(np.median(list(gn.values())))
    moving = {n for n, v in gn.items() if v >= 1e-3 * median}
    grad = norm_gaps(got["first_grad"], want["first_grad"])
    change = norm_gaps(got["change"], want["change"], keep=moving.__contains__)
    grad_worst, change_worst = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": max(losses), "grad_gap": grad[grad_worst],
            "change_gap": change[change_worst],
            "grad_gap_median": float(np.median(list(grad.values()))),
            "grad_gap_p90": float(np.quantile(list(grad.values()), 0.9)),
            "lora_grad_cos_gap": _cos_gap(got["first_grad"], want["first_grad"], ".lora_"),
            "change_gap_median": float(np.median(list(change.values()))),
            "_worst": f"grad {grad_worst}, change {change_worst}",
            "_worst_grad_norm": gn[grad_worst], "_median_grad_norm": median,
            "_left_out": len(gn) - len(moving)}


def _cos_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], part: str) -> float:
    """1 - the cosine between the program's and the reference's tensors whose
    names hold ``part``, each side flattened into one vector (0 where none)."""
    names = sorted(n for n in want if part in n)
    if not names:
        return 0.0
    g = torch.cat([got[n].double().flatten().cpu() for n in names])
    w = torch.cat([want[n].double().flatten().cpu() for n in names])
    return float(1.0 - torch.dot(g, w) / (g.norm() * w.norm()).clamp_min(1e-300))
