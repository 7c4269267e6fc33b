"""Batch tile inference CLI on PyTorch (tile mode of the root ``run_inference.py``).

Usage:
  python -m mipheivit_tpu_torch.run_inference --checkpoint_dir D
         [--dataset_config_path C] [--batch_size N] [--device cuda]

Reads ``D/config.yaml`` (the resolved run config saved beside the
checkpoint), optionally overrides the dataframe paths from a dataset config
file, and writes per-tile prediction TIFFs to
``D/inference_<dataset>_<run>/``. Config parsing and tile/TIFF IO are the JAX
package's jax-free host modules, imported here only.
"""

import argparse
from pathlib import Path


def main(argv=None) -> str:
    from mipheivit_tpu.config import load_yaml

    from .infer import inference_model

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True, help="Checkpoint Path")
    parser.add_argument("--dataset_config_path", default=None,
                        help="Optional dataset-specific config file (in configs/data/).")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda when available, else cpu)")
    args = parser.parse_args(argv)

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

    dataset_name = Path(args.dataset_config_path).stem \
        if args.dataset_config_path else "default"
    run_name = Path(args.checkpoint_dir).stem
    out_dir = str(Path(args.checkpoint_dir) / f"inference_{dataset_name}_{run_name}")
    return inference_model(cfg, args.checkpoint_dir, out_dir,
                           batch_size=args.batch_size, device=args.device)


if __name__ == "__main__":
    main()
