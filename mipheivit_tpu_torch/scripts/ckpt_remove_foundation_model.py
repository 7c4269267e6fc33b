"""Shrink a generator checkpoint: drop the frozen foundation encoder's
weights, keep the LoRA adapters and the decoder (the port's copy of
``scripts/ckpt_remove_foundation_model.py``).

Usage:
  python -m mipheivit_tpu_torch.scripts.ckpt_remove_foundation_model
      --checkpoint C --out O.safetensors

Reads a safetensors file or a torch pickle (``infer.loading.load_state_dict``)
and writes safetensors (``io.safetensors``). Loading the result needs the
foundation encoder's own checkpoint beside it (``infer.loading``).
"""

from __future__ import annotations

import argparse

from ..infer.loading import load_state_dict
from ..io.safetensors import save_file


def strip_foundation(state: dict) -> dict:
    return {key: val for key, val in state.items()
            if not (key.startswith("encoder.vit.") and ".lora" not in key)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    state = load_state_dict(args.checkpoint)
    stripped = strip_foundation(state)
    save_file(stripped, args.out)
    print(f"{len(state)} -> {len(stripped)} tensors: {args.out}")


if __name__ == "__main__":
    main()
