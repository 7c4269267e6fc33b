"""A tiny copy of the benchmark for CPU tests: the same drivers and
readers, configurations at test widths, and the port's encoder specs
patched to them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import torch

from benchmark import harness

HERE = harness.HERE

TINY_ENCODER = {"patch_size": 14, "embed_dim": 64, "depth": 4, "num_heads": 2,
                "mlp_hidden_dim": 128}
TRAFFIC = {
    "tiles-256-b64": {"tile": 128, "pool": 8, "batch": 4, "warmup_batches": 1, "check_tiles": 4},
    "train-region1024-lora": {"img": 128, "pool_microbatches": 8},
}
LOOSE = 1e9


def make(tmp: Path, loose: bool = True) -> Path:
    """The benchmark's files at test sizes under ``tmp``; returns the base.
    With ``loose`` every limit but an exact one is set out of reach (the
    limits were read at the cells' sizes on the card)."""
    base = tmp / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (base / d).mkdir(parents=True, exist_ok=True)
    for d in ("drivers", "metrics"):
        shutil.copytree(HERE / d, base / d, dirs_exist_ok=True)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        cfg["encoder"].update(TINY_ENCODER)
        (base / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
        c["file"] = str(base / "configs" / f"{c['name']}.json")
    for name, change in TRAFFIC.items():
        t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
        t.update(change)
        (base / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for w in bench["workloads"]:
        lim = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
        if loose:
            lim = {k: (v if v == 0 else LOOSE) for k, v in lim.items()}
        (base / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def patch_specs(monkeypatch, base: Path):
    """The port's encoder specs at the tiny configurations' widths."""
    from mipheivit_tpu_torch.models import foundation

    for f in (base / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        kw, repo = foundation._VIT_SPECS[cfg["encoder_name"]]
        kw = dict(kw, **{k: cfg["encoder"][k] for k in TINY_ENCODER})
        monkeypatch.setitem(foundation._VIT_SPECS, cfg["encoder_name"], (kw, repo))


def cell(base: Path, name: str) -> harness.Cell:
    bench = json.loads((base / "BENCHMARK.json").read_text())
    return harness.Cell(name, bench=bench, root=base, base=base)


def run(base: Path, name: str, seed: int = 7, seconds: float = 0.5, trace: bool = False):
    torch.manual_seed(0)
    return harness.execute(cell(base, name), seed, seconds, trace, torch.device("cpu"))
