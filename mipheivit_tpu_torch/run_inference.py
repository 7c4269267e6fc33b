"""Inference CLI on PyTorch (the root ``run_inference.py``'s tile and WSI modes).

Usage:
  python -m mipheivit_tpu_torch.run_inference --checkpoint_dir D
         [--dataset_config_path C] [--batch_size N] [--device cuda]
         [--wsi SLIDE [--out OUT.ome.tiff] [--tile_size 256] [--overlap 64]]

Reads ``D/config.yaml`` (the resolved run config saved beside the
checkpoint), optionally overrides the dataframe paths from a dataset config
file, and writes per-tile prediction TIFFs to
``D/inference_<dataset>_<run>/`` -- or, with ``--wsi``, runs stitched
sliding-window inference over a whole slide into a pyramidal OME-TIFF
(``--tile_size 1024 --overlap 128`` for whole-region windows). Runs on the
card unless ``--device cpu`` is given; without a card it raises. Config
parsing (``config.py``) and slide/TIFF IO (``slideio``) are the port's own
host modules, imported here only.
"""

import argparse
from pathlib import Path


def main(argv=None) -> str:
    from .config import load_yaml

    from .infer import inference_model

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True, help="Checkpoint Path")
    parser.add_argument("--dataset_config_path", default=None,
                        help="Optional dataset-specific config file (in configs/data/).")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without a card, "
                             "pass cpu to run on the CPU)")
    parser.add_argument("--wsi", default=None,
                        help="Whole-slide path: run stitched sliding-window inference")
    parser.add_argument("--out", default=None, help="Output path for --wsi mode")
    parser.add_argument("--tile_size", default=256, type=int)
    parser.add_argument("--overlap", default=64, type=int)
    parser.add_argument("--int8", action="store_true",
                        help="not ported yet (ROADMAP.md queue 1, item 16)")
    parser.add_argument("--seq_shard", action="store_true",
                        help="not ported yet (ROADMAP.md queue 1, items 13-14)")
    args = parser.parse_args(argv)
    if args.int8:
        raise NotImplementedError("--int8 serving is not ported to PyTorch yet "
                                  "(ROADMAP.md queue 1, item 16: int8 serving)")
    if args.seq_shard:
        raise NotImplementedError("--seq_shard is not ported to PyTorch yet "
                                  "(ROADMAP.md queue 1, items 13-14: parallel/seq.py, "
                                  "whole-region encoding over several cards)")

    cfg = load_yaml(str(Path(args.checkpoint_dir) / "config.yaml"))
    if args.dataset_config_path:
        if not Path(args.dataset_config_path).exists():
            raise FileNotFoundError(
                f"Dataset config {args.dataset_config_path} not found.")
        ds_cfg = load_yaml(args.dataset_config_path)
        ds_data = ds_cfg.select("data", ds_cfg)
        for key in ("slide_dataframe_path", "train_dataframe_path",
                    "val_dataframe_path", "test_dataframe_path",
                    "channel_stats_path"):
            if key in ds_data:
                cfg.data[key] = ds_data[key]

    if args.wsi:
        return _run_wsi(cfg, args)
    dataset_name = Path(args.dataset_config_path).stem \
        if args.dataset_config_path else "default"
    run_name = Path(args.checkpoint_dir).stem
    out_dir = str(Path(args.checkpoint_dir) / f"inference_{dataset_name}_{run_name}")
    return inference_model(cfg, args.checkpoint_dir, out_dir,
                           batch_size=args.batch_size, device=args.device)


def _run_wsi(cfg, args) -> str:
    """The generator at ``(tile_size, tile_size)`` (position embedding
    re-gridded), LoRA merged, bf16 on the card; then ``wsi_inference``."""
    from .infer import load_serving_model, resolve_device, wsi_inference

    device = resolve_device(args.device)
    names = list(cfg.data.targ_channel_names)
    model, he_norm = load_serving_model(cfg, args.checkpoint_dir,
                                        (args.tile_size, args.tile_size), len(names), device)
    out = args.out or str(Path(args.wsi).with_suffix(".pred.ome.tiff"))
    return wsi_inference(model, args.wsi, out, names, he_norm,
                         tile_size=args.tile_size, overlap=args.overlap,
                         batch_size=args.batch_size or cfg.train.batch_size)


if __name__ == "__main__":
    main()
