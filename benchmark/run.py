"""Run one cell of BENCHMARK.json once on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program. Every cache the
run writes stays inside the checkout, under ``.bench_cache/`` (the
program's own kernel builds go to ``mipheivit_tpu_torch/build/``).
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:]))
