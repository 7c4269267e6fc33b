"""HEMIT benchmark evaluation of HEMIT-codebase checkpoints (reference:
evaluation/eval_hemit_hemit_pipeline.py).

Usage:
  python -m mipheivit_tpu_torch.evaluation.eval_hemit_hemit_pipeline
      --checkpoint_dir D [--dataset_config_path P] [--batch_size 4]
      [--netG SwinTResnet] [--new_timm_layout] [--device cpu]

``eval_hemit``'s half-resolution (20x) inference and 5 %-train-cell gating,
with the generator, built for half the tile width, loaded as in
``eval_orion_hemit_pipeline``. Writes ``hemit_results_logreg_{val,test}.csv``
(and the XGBoost tables when xgboost is there). Runs on the card unless
``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

from . import eval_hemit
from .common import DATA_CONFIGS, load_eval_config
from .eval_orion_hemit_pipeline import forward_builder, parse_args

DATASET_CONFIG_PATH = str(DATA_CONFIGS / "hemit.yaml")


def run(cfg, checkpoint_dir: str, batch_size: int = 4, device=None, netG: str = "SwinTResnet",
        old_timm_layout: bool = True) -> dict:
    return eval_hemit.run(cfg, checkpoint_dir, batch_size, device,
                          forward_builder=forward_builder(old_timm_layout, netG))


def main(argv=None) -> dict:
    args = parse_args(argv, DATASET_CONFIG_PATH)
    cfg = load_eval_config(args.checkpoint_dir, args.dataset_config_path)
    return run(cfg, args.checkpoint_dir, args.batch_size, args.device, args.netG,
               not args.new_timm_layout)


if __name__ == "__main__":
    main()
