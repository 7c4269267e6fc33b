"""One run of one cell: find its files by name, check the card, drive the
cell's driver, reduce the traced window, and print the result line.

The result is the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``
and, traced, ``breakdown``; the numbers compared for ``correct`` come last,
under ``checks``, and again as the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import spans as spans_mod
from . import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mipheivit_tpu"}


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    import os

    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A file of the benchmark as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark._loaded.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` and everything found by its names."""

    def __init__(self, name: str, bench: Optional[dict] = None, root: Path = ROOT,
                 base: Path = HERE):
        self.bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
        self.base = base
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.config.setdefault("name", self.entry["config"])
        self.traffic = load_json(base / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(base / "limits" / f"{name}.json")
        self.driver_path = base / "drivers" / f"{self.traffic['driver']}.py"

    def metrics(self, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.base / "metrics" / f"{metric}.py", metric.replace(".", "_"))


class Run:
    """What a driver hands the harness: the rates it measured, the work it
    counted, the numbers it compared, and (traced) the timeline."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.config, self.traffic = cell.config, cell.traffic
        self.e2e: Dict[str, float] = {}
        self.stats: Dict[str, float] = {}
        self.checks: List[tuple] = []
        self.numbers: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.setup_s = None
        self.memory_peak = None
        self.window = trace_mod.Window(trace)
        self.spans = None
        self.timeline = None

    def instrument(self, model):
        """The benchmark's spans around the model's layers (traced runs)."""
        if self.trace:
            self.spans = spans_mod.Spans().install(model, self.config["decoder_span"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin_window(self):
        self.sync()
        self.setup_s = process_age_s()
        self.window.start()
        return self.window.t0

    def end_window(self):
        self.sync()
        self.window.stop()
        if self.spans is not None:
            self.spans.remove()
        return self.window.t1

    def read_peak(self):
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        """Release the program's memory before the reference runs."""
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, name: str, value: float, limit: float):
        """One compared number; ``correct`` needs every value at or under its limit."""
        self.checks.append((name, float(value), float(limit)))

    def limit(self, name: str) -> float:
        return float(self.cell.limits[name])


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def launch_counts() -> dict:
    from mipheivit_tpu_torch.ops import attention, mlp, seg_heads

    out = {}
    for mod in (attention, mlp, seg_heads):
        out.update(mod.launch_counts)
    return dict(out)


def per_layer(run: Run) -> Dict[str, dict]:
    out = {}
    for m in run.cell.metrics("per_layer"):
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(run: Run) -> Dict[str, dict]:
    out = {}
    for m in run.cell.metrics("end_to_end"):
        value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
        if value is None:
            raise RuntimeError(f"{run.cell.name}: the driver measured no {m['name']}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Drive one run and return the result object (without printing)."""
    run = Run(cell, seed, seconds, trace, device)
    driver = load_module(cell.driver_path, f"driver_{cell.traffic['driver']}")
    driver.run(run)
    if run.trace:
        run.timeline = run.window.reduce()
    result = {
        "correct": bool(run.checks) and all(v <= lim for _, v, lim in run.checks),
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": per_layer(run) if trace else end_to_end(run),
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": int(run.memory_peak or 0)},
    }
    if run.failed:
        result["correct"] = False
    if trace and run.timeline is not None:
        tl = run.timeline
        result["device"]["busy_s"] = tl.busy_s
        result["device"]["window_s"] = tl.window_s
        result["breakdown"] = tl.breakdown()
        print(f"[trace] {len(tl.device)} device activities, {tl.unlinked} not linked to a "
              f"host launch; spans: " + ", ".join(f"{n} {tl.span_count(n)}"
                                                  for n in sorted(tl.spans)),
              file=sys.stderr, flush=True)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return result


def main(argv) -> int:
    args = parse(argv)
    cell = Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), found {n}; "
              "no result", file=sys.stderr)
        return 2
    import mipheivit_tpu_torch  # noqa: F401  (fails in a checkout without the program)

    print(f"[card] {card_line()}; devices {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    print(f"[launch counts] {json.dumps(launch_counts())}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    print(f"[run] {args.workload} seed {args.seed}: {time.perf_counter() - t0:.1f} s after "
          "the card check", file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
