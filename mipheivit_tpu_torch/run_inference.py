"""Inference CLI on PyTorch (the root ``run_inference.py``'s tile and WSI modes).

Usage:
  python -m mipheivit_tpu_torch.run_inference --checkpoint_dir D
         [--dataset_config_path C] [--batch_size N] [--device cuda]
         [--wsi SLIDE [--out OUT.ome.tiff] [--tile_size 256] [--overlap 64] [--int8]]

Reads ``D/config.yaml`` (the resolved run config saved beside the
checkpoint), optionally overrides the dataframe paths from a dataset config
file, and writes per-tile prediction TIFFs to
``D/inference_<dataset>_<run>/`` -- or, with ``--wsi``, runs stitched
sliding-window inference over a whole slide into a pyramidal OME-TIFF
(``--tile_size 1024 --overlap 128`` for whole-region windows). Runs on the
card unless ``--device cpu`` is given; without a card it raises.

``--int8`` serves the slide in W8A8 (``infer.loading.quantize_encoder`` then
``quantize_decoder`` after the load: the encoder's linears and the
decoder's fusion convs in int8, ``ops/quant.py``), with or without
``--seq_shard``. Tile mode ignores it, as the JAX CLI does (its tile path
never reads the flag), and says so in the log. Config
parsing (``config.py``) and slide/TIFF IO (``slideio``) are the port's own
host modules, imported here only.

Whole-region windows sharded over several cards, one process a card:

  python -m torch.distributed.run --nproc_per_node N -m mipheivit_tpu_torch.run_inference
         --checkpoint_dir D --wsi SLIDE --tile_size 2048 --overlap 128 --seq_shard

Every rank starts the process group (``parallel.init_distributed``: NCCL on
``cuda:{LOCAL_RANK}``, gloo with ``--device cpu``), the ranks form a ``1 x
N`` mesh whose model group shards each window's tokens (``parallel/seq.py``),
and rank 0 writes the slide. ``--seq_shard`` needs 2 ranks or more; without
it the CLI runs in one process.
"""

import argparse
import logging
from pathlib import Path

log = logging.getLogger(__name__)


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
                        help="W8A8 serving for --wsi: the encoder's linears and the decoder's "
                             "fusion convs in int8 (tile mode ignores it, as the JAX CLI does)")
    parser.add_argument("--seq_shard", action="store_true",
                        help="whole-region serving: shard each window's tokens over the "
                             "ranks of torchrun (2 or more; use with --wsi and a large "
                             "--tile_size, e.g. 1024/2048)")
    args = parser.parse_args(argv)
    from .parallel.mesh import init_distributed, make_mesh, world_size

    seq_mesh = None
    if args.seq_shard:
        if not args.wsi:
            raise ValueError("--seq_shard shards whole-slide windows: use it with --wsi")
        if world_size() < 2:
            raise ValueError(
                "--seq_shard shards each window's tokens over the ranks of torchrun: launch 2 "
                "or more (python -m torch.distributed.run --nproc_per_node N -m "
                "mipheivit_tpu_torch.run_inference ... --seq_shard)")
        init_distributed(args.device)
        seq_mesh = make_mesh(n_data=1, n_model=world_size())
    elif world_size() > 1:
        raise ValueError("run_inference runs in one process unless --seq_shard shards its "
                         "windows over the ranks")

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
        return _run_wsi(cfg, args, seq_mesh)
    if args.int8:
        log.warning("--int8 applies to --wsi; tile mode runs in the compute dtype")
    dataset_name = Path(args.dataset_config_path).stem \
        if args.dataset_config_path else "default"
    run_name = Path(args.checkpoint_dir).stem
    out_dir = str(Path(args.checkpoint_dir) / f"inference_{dataset_name}_{run_name}")
    return inference_model(cfg, args.checkpoint_dir, out_dir,
                           batch_size=args.batch_size, device=args.device)


def _run_wsi(cfg, args, seq_mesh=None):
    """The generator at ``(tile_size, tile_size)`` (position embedding
    re-gridded), LoRA merged, bf16 on the card, with ``--int8`` quantised;
    then ``wsi_inference`` (with ``seq_mesh``, its ViT sequence-sharded over
    the ranks; ranks other than 0 return None)."""
    from .infer import load_serving_model, resolve_device, wsi_inference
    from .infer import loading
    from .models.vit import set_attn_impl
    from .parallel.mesh import process_device

    device = resolve_device(args.device if seq_mesh is None else process_device())
    names = list(cfg.data.targ_channel_names)
    model, he_norm = load_serving_model(cfg, args.checkpoint_dir,
                                        (args.tile_size, args.tile_size), len(names), device)
    if args.int8:
        loading.quantize_decoder(loading.quantize_encoder(model))
    if seq_mesh is not None:
        set_attn_impl(model, "seq_shard")
    out = args.out or str(Path(args.wsi).with_suffix(".pred.ome.tiff"))
    return wsi_inference(model, args.wsi, out, names, he_norm,
                         tile_size=args.tile_size, overlap=args.overlap,
                         batch_size=args.batch_size or cfg.train.batch_size,
                         seq_shard_mesh=seq_mesh)


if __name__ == "__main__":
    main()
