"""Eval-only entry point on PyTorch (the root ``run_test.py``'s counterpart).

Usage:
  python -m mipheivit_tpu_torch.run_test --checkpoint_dir LOGDIR [--device cpu]

Re-runs the val and test epochs of a finished run from its checkpoint dir
(``config.yaml`` and ``model.safetensors``), appending their pixel metrics
to ``LOGDIR/metrics.jsonl``. Runs on the card unless ``--device cpu`` is
given; without a card it raises. Reading ``config.yaml`` needs PyYAML.
"""

import argparse
import logging
from pathlib import Path


def main(argv=None) -> dict:
    from .config import load_yaml
    from .train.test_driver import test_model

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True, help="Checkpoint Path")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without a card, "
                             "pass cpu to run on the CPU)")
    args = parser.parse_args(argv)
    cfg = load_yaml(str(Path(args.checkpoint_dir) / "config.yaml"))
    return test_model(cfg, args.checkpoint_dir, Path(args.checkpoint_dir).stem,
                      device=args.device)


if __name__ == "__main__":
    main()
