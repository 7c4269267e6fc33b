"""ORION evaluation of HEMIT-codebase checkpoints (reference:
evaluation/eval_orion_hemit_pipeline.py).

Usage:
  python -m mipheivit_tpu_torch.evaluation.eval_orion_hemit_pipeline
      --checkpoint_dir D [--dataset_config_path P] [--batch_size 4]
      [--netG SwinTResnet] [--new_timm_layout] [--device cpu]

``eval_orion``'s cell-level pipeline, with the generator a HEMIT-codebase
one: ``latest_net_G.pth``, ``model.pth`` or ``net_G.pth`` in the checkpoint
dir, built by ``models.hemit.build_hemit_netG`` for ``--netG`` and loaded by
``models.import_hemit`` (the dual-branch generator with the older timm's
downsample keys unless ``--new_timm_layout``). Its tanh output is scaled by
0.9 into the IF codec's range. Writes ``eval_orion``'s artefacts. Runs on
the card unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .._device import resolve_device
from ..infer.loading import cast_params, load_state_dict
from ..models.hemit import build_hemit_netG
from ..models.import_hemit import IMPORTERS, hemit_swint_from_torch
from . import eval_orion
from .common import DATA_CONFIGS, load_eval_config

DATASET_CONFIG_PATH = str(DATA_CONFIGS / "orion.yaml")
CHECKPOINT_NAMES = ("latest_net_G.pth", "model.pth", "net_G.pth")
# tanh [-1, 1] -> the IF codec's [-0.9, 0.9]: the reference's
# (out + 1) / 2 * 1.8 - 0.9 (eval_orion_hemit_pipeline.py:187-191)
IF_SCALE = 0.9


def build_hemit_forward(checkpoint_dir: str, width: int, nc_out: int,
                        old_timm_layout: bool = True, netG: str = "SwinTResnet", device=None):
    """A HEMIT-codebase generator from ``checkpoint_dir`` as
    ``x [B, H, W, 3] -> 0.9 * G(x)``, built for ``width`` px; bf16 on the
    card, f32 on the CPU."""
    device = resolve_device(device)
    ckpt = next((Path(checkpoint_dir) / n for n in CHECKPOINT_NAMES
                 if (Path(checkpoint_dir) / n).exists()), None)
    if ckpt is None:
        raise FileNotFoundError(f"no HEMIT generator checkpoint in {checkpoint_dir}")
    if netG not in IMPORTERS:
        raise NotImplementedError(f"no checkpoint importer for netG={netG!r}")
    state = load_state_dict(ckpt)
    with torch.device(device):
        model = build_hemit_netG(netG, width, 3, nc_out)
    if netG == "SwinTResnet":
        hemit_swint_from_torch(state, model, old_timm_layout=old_timm_layout)
    else:
        IMPORTERS[netG](state, model)
    model = cast_params(model.eval(), torch.bfloat16 if device.type == "cuda" else torch.float32)

    def fwd(x):
        with torch.inference_mode():
            return model(x) * IF_SCALE

    return fwd


def forward_builder(old_timm_layout: bool = True, netG: str = "SwinTResnet"):
    """``build_hemit_forward`` in the evaluation scripts'
    ``forward_builder`` form (square crops: the width alone sizes it)."""

    def build(cfg, checkpoint_dir, width, height, nc_out, device):
        return build_hemit_forward(checkpoint_dir, width, nc_out, old_timm_layout, netG, device)

    return build


def parse_args(argv, dataset_config_path: str):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", type=str, required=True)
    parser.add_argument("--dataset_config_path", default=dataset_config_path)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--netG", default="SwinTResnet",
                        help="HEMIT generator variant (the reference get_generator_hemit names)")
    parser.add_argument("--new_timm_layout", action="store_true",
                        help="skip the older timm's downsample key shift")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu to run on the CPU)")
    return parser.parse_args(argv)


def run(cfg, checkpoint_dir: str, batch_size: int = 4, device=None, netG: str = "SwinTResnet",
        old_timm_layout: bool = True) -> dict:
    return eval_orion.run(cfg, checkpoint_dir, batch_size, device,
                          forward_builder=forward_builder(old_timm_layout, netG))


def main(argv=None) -> dict:
    args = parse_args(argv, DATASET_CONFIG_PATH)
    cfg = load_eval_config(args.checkpoint_dir, args.dataset_config_path)
    return run(cfg, args.checkpoint_dir, args.batch_size, args.device, args.netG,
               not args.new_timm_layout)


if __name__ == "__main__":
    main()
