"""The harness finds everything by name, takes a new cell or metric from
files alone, keeps to the result contract, and loads no JAX."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.reference import models
from benchmark.tests import tiny

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_is_found():
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.driver_path.exists()
        assert cell.limits, w["name"]
        for m in cell.metrics("per_layer"):
            assert hasattr(cell.reader(m["name"]), "read")
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert hasattr(models.encoder(cfg), "forward") and hasattr(models.decoder(cfg), "shapes")


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    reported = {w["name"]: {m["name"] for m in harness.Cell(w["name"]).metrics("end_to_end")}
                for w in BENCH["workloads"]}
    for w, metrics in reported.items():
        assert "setup_s" in metrics and len(metrics) >= 2
        assert harness.Cell(w).metrics("per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in reported[w]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _add_cell(base: Path, bench: dict):
    (base / "traffic" / "tiles-128-b2.json").write_text(json.dumps(
        {"driver": "tiles", "tile": 128, "pool": 4, "batch": 2, "warmup_batches": 1,
         "check_tiles": 2}))
    (base / "limits" / "hopt0-tiles128.json").write_text(json.dumps({"mean_abs": 1e9}))
    bench["workloads"].append({"name": "hopt0-tiles128", "config": "mipheivit-hoptimus0",
                               "traffic": "tiles-128-b2", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "tiles_s":
            m["workloads"].append("hopt0-tiles128")
    (base / "metrics" / "tile_calls.tiles.py").write_text(
        "def read(run):\n    return run.stats.get('batches')\n")
    bench["per_layer"].append({"name": "tile_calls.tiles", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "infer/tiles.py",
                               "moves": "tiles_s", "workloads": ["hopt0-tiles128"]})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_and_a_metric_from_files_alone(tmp_path, monkeypatch, trace):
    base = tiny.make(tmp_path)
    tiny.patch_specs(monkeypatch, base)
    _add_cell(base, json.loads((base / "BENCHMARK.json").read_text()))
    res = tiny.run(base, "hopt0-tiles128", trace=trace)
    assert res["correct"] and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    if trace:
        assert res["metrics"]["tile_calls.tiles"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    else:
        assert set(res["metrics"]) == {"tiles_s", "setup_s"}


def test_no_result_without_a_card():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hopt0-tiles256",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if "needs 1 CUDA device" not in proc.stderr:
        pytest.skip("a card is present")
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_no_result_without_the_program(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(ROOT / "benchmark"), str(tmp_path)], check=True)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hopt0-tiles256",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
import benchmark.harness, benchmark.calibrate, benchmark.compare
from benchmark.drivers import tiles, train
from benchmark.tests import tiny
class MP:
    def setitem(self, d, k, v): d[k] = v
base = tiny.make(Path({str(tmp_path)!r}))
tiny.patch_specs(MP(), base)
for name in ("uni2h-tiles256", "hopt0-train1024"):
    tiny.run(base, name, trace=True)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "mipheivit_tpu"))
print("BAD", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout
