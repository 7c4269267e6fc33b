"""Readings for a cell's output limits, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 [--seconds 5]
        [--control | --fault half_batch]

Without ``--control`` each seed is one run of the cell (a short window) and
prints the numbers its comparison read; with ``--control`` the cell's
driver runs its control (the program's own int8 path, or the reference in
float8 e4m3 in the program's place) at the cell's size; ``--fault`` plants a fault
of the training step in the reference put in the program's place. The
last line is a JSON list of every seed's numbers. ``PERF.md`` gives the
readings each limit in ``limits/`` was set from.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    print(f"[card] {harness.card_line()}", flush=True)
    driver = harness.load_module(cell.driver_path, f"driver_{cell.traffic['driver']}")
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control or args.fault:
            r = harness.Run(cell, seed, args.seconds, False, device)
            kw = {"fault": args.fault} if args.fault else {}
            what, nums = driver.control(r, **kw)
            rec = {"seed": seed, "what": what, "numbers": nums}
        else:
            r = harness.Run(cell, seed, args.seconds, False, device)
            driver.run(r)
            rec = {"seed": seed, "what": "program", "numbers": r.numbers, "e2e": r.e2e,
                   "correct": all(v <= lim for _, v, lim in r.checks) and not r.failed}
        rec["seconds"] = time.perf_counter() - t0
        print(f"[calibrate] {json.dumps(rec)}", flush=True)
        out.append(rec)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
