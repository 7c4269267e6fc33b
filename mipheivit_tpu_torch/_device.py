"""The port's device policy: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` when given, else the card. Nothing falls back to the CPU:
    without a card the CPU runs only when asked for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        device = "cuda"
    return torch.device(device)
