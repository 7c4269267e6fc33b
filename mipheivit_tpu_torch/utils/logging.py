"""Observability: metrics stream + debug image dumps.

The port's copy of ``mipheivit_tpu/utils/logging.py``. The reference's
backbone is Weights & Biases (reference: src/train.py:173-179,
src/callbacks.py); here the primary sink is a local ``metrics.jsonl``
(always on, greppable, survives offline runs) with W&B mirroring when the
package is importable, plus the ``DebugImageLogger``-style PNG grids
(reference: src/callbacks.py:19-118), written by a stdlib PNG encoder
(``zlib`` + ``struct``; no cv2 on the machine with the card).
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, logdir: str, project: Optional[str] = None,
                 run_name: Optional[str] = None, config: Optional[Dict] = None,
                 use_wandb: bool = True):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.path = self.logdir / "metrics.jsonl"
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=project or "mipheivit-tpu", name=run_name,
                    dir=str(self.logdir), config=config or {})
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None):
        payload = {"time": time.time()}
        if step is not None:
            payload["step"] = int(step)
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, (int, float, bool, str)) and not (
                    isinstance(v, float) and not np.isfinite(v)):
                payload[k] = v
        self._fh.write(json.dumps(payload) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(
                {k: v for k, v in payload.items() if k != "time"}, step=step)

    def finish(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


def save_image_grid(path: str, he: np.ndarray, pred: np.ndarray,
                    target: Optional[np.ndarray] = None,
                    max_images: int = 4) -> None:
    """Input | per-marker predictions | targets grid as one PNG
    (reference DebugImageLogger semantics: src/callbacks.py:19-118)."""
    n = min(max_images, he.shape[0])
    rows = []
    for i in range(n):
        cols = [np.clip(he[i], 0, 255).astype(np.uint8)]
        pr = ((np.clip(pred[i], -0.9, 0.9) + 0.9) / 1.8 * 255).astype(np.uint8)
        for c in range(pr.shape[-1]):
            cols.append(np.repeat(pr[..., c:c + 1], 3, axis=-1))
        if target is not None:
            tg = ((np.clip(target[i], -0.9, 0.9) + 0.9) / 1.8 * 255).astype(np.uint8)
            for c in range(tg.shape[-1]):
                cols.append(np.repeat(tg[..., c:c + 1], 3, axis=-1))
        rows.append(np.concatenate(cols, axis=1))
    grid = np.concatenate(rows, axis=0)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(grid))


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an ``[H, W, 3]`` uint8 array: the signature, one
    IHDR, one IDAT (each row behind filter byte 0, deflated) and IEND."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {rgb.shape}")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
