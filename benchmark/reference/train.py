"""The flagship's training step, plainly: weighted MSE, the gradients of the
trainable tensors (LoRA adapters and the decoder), the accumulated mean,
the global-norm clip, Adam and the pix2pix schedule (optax's arithmetic as
the configuration states it).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import models


def trainable(name: str) -> bool:
    """LoRA adapters and everything outside the encoder train; the rest of
    the encoder is frozen."""
    if name.startswith("encoder."):
        return ".lora_q." in name or ".lora_v." in name
    return True


def schedule(step: int, warmup: int, total: int) -> float:
    """Linear warm-up, constant, then linear decay to 0 from total / 2."""
    decay_start = total // 2
    if step < warmup:
        return step / max(warmup, 1)
    if step < decay_start:
        return 1.0
    return max(0.0, 1.0 - (step - decay_start) / max(total - decay_start, 1))


def weighted_mse(y, pred, weights: torch.Tensor, lam: float):
    per = torch.mean((y - pred) ** 2, dim=(0, 1, 2))
    return torch.mean(per * weights) * lam


class AdamReference:
    """clip_by_global_norm(max_norm) -> Adam(b1, b2, eps) -> schedule -> -lr."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.opt = opt
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        o = self.opt
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        factor = 1.0 if norm < o["clip"] else o["clip"] / float(norm)
        b1, b2 = o["b1"], o["b2"]
        sched = schedule(self.count, o["warmup"], o["total_iters"])
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        clipped = {}
        for n, p in params.items():
            g = grads[n] * factor
            clipped[n] = g
            self.mu[n] = (1 - b1) * g + b1 * self.mu[n]
            self.nu[n] = (1 - b2) * g * g + b2 * self.nu[n]
            update = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + o["eps"])
            p.add_(update * (-o["lr"] * sched))
        return clipped


def run_steps(cfg, p: Dict[str, torch.Tensor], batches: Sequence[dict], opt: dict,
              n_opt_steps: int, quant=None) -> dict:
    """``n_opt_steps`` optimizer steps of ``opt["accum"]`` microbatches each
    from ``batches`` (``image`` normalized NHWC f32, ``target`` NHWC f32),
    from the tensors ``p`` (changed in place). Returns each microbatch's
    loss, the first step's clipped mean gradient and the change of each
    trainable tensor after the last step."""
    names = [n for n in sorted(p) if trainable(n) and "running_" not in n]
    params = {n: p[n].requires_grad_(True) for n in names}
    start = {n: t.detach().clone() for n, t in params.items()}
    adam = AdamReference(params, opt)
    weights = torch.tensor(opt["marker_weights"], dtype=torch.float32,
                           device=next(iter(params.values())).device)
    losses: List[float] = []
    first_grad = None
    k = opt["accum"]
    for s in range(n_opt_steps):
        acc = {n: torch.zeros_like(t) for n, t in params.items()}
        for a in range(k):
            b = batches[s * k + a]
            pred = models.forward(cfg, p, b["image"], training=True, quant=quant, checkpoint=True)
            loss = weighted_mse(b["target"], pred, weights, opt["lambda"])
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for n, g in zip(names, grads):
                    acc[n] += (g - acc[n]) / (a + 1)
            del pred, loss, grads
        clipped = adam.step(params, acc)
        if s == 0:
            first_grad = {n: g.detach().clone() for n, g in clipped.items()}
    change = {n: (params[n].detach() - start[n]) for n in names}
    for t in params.values():
        t.requires_grad_(False)
    return {"losses": losses, "first_grad": first_grad, "change": change}
