"""IMMUCAN external validation of HEMIT-codebase checkpoints (reference:
evaluation/eval_immucan_hemit_pipeline.py).

Usage:
  python -m mipheivit_tpu_torch.evaluation.eval_immucan_hemit_pipeline
      --checkpoint_dir D [--dataset_config_path P] [--batch_size 4]
      [--netG SwinTResnet] [--new_timm_layout] [--device cpu]

``eval_immucan``'s per-tile Pearson analysis with the generator loaded as
in ``eval_orion_hemit_pipeline`` and pix2pix's input normalisation
(``(x - 127.5) / 127.5``, reference :125-126); the logistic-regression gate
is the checkpoint dir's ``logreg.npz`` / ``logreg.pth``. Writes
``immucan_corr.csv`` and ``immucan_tile_sums.csv``. Runs on the card unless
``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

from ..data.stats import Normalizer
from . import eval_immucan
from .common import DATA_CONFIGS, load_eval_config
from .eval_orion_hemit_pipeline import forward_builder, parse_args

DATASET_CONFIG_PATH = str(DATA_CONFIGS / "immucan.yaml")


def run(cfg, checkpoint_dir: str, batch_size: int = 4, device=None, netG: str = "SwinTResnet",
        old_timm_layout: bool = True) -> dict:
    he_norm = Normalizer({"mean": [127.5] * 3, "std": [127.5] * 3}, mode="he")
    return eval_immucan.run(cfg, checkpoint_dir, batch_size, device,
                            forward_builder=forward_builder(old_timm_layout, netG),
                            he_norm=he_norm)


def main(argv=None) -> dict:
    args = parse_args(argv, DATASET_CONFIG_PATH)
    cfg = load_eval_config(args.checkpoint_dir, args.dataset_config_path)
    return run(cfg, args.checkpoint_dir, args.batch_size, args.device, args.netG,
               not args.new_timm_layout)


if __name__ == "__main__":
    main()
