"""The stage clock of the slide passes that run on the card (``mif_cleaning``,
``extract_expression_matrix``): host arrays go up through pinned memory,
and each stage's seconds are booked apart."""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

STAGES = ("read", "upload", "device", "write")


class StageClock:
    """Seconds spent in each stage of a pass over a slide: ``read`` (the
    slide reader), ``upload`` (host to device), ``device`` (the arithmetic
    and the fetch of its result) and ``write`` (the output's writer). On the
    card ``upload`` and ``device`` end at a synchronize, so the stages add
    up to the pass's wall."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.seconds = dict.fromkeys(STAGES, 0.0)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda" and name in ("upload", "device"):
            torch.cuda.synchronize(self.device)
        self.seconds[name] += time.perf_counter() - t0

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device in its own dtype (uint16 stays uint16),
        through pinned memory on the card."""
        with self.stage("upload"):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            return t

    def text(self) -> str:
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.seconds.items())
