"""ROI inference demo: H&E region -> predicted mIF + on-the-fly cell typing
(the port's copy of ``examples/roi_inference.py``).

Usage:
  python -m mipheivit_tpu_torch.examples.roi_inference --checkpoint_dir D
      --input SLIDE_OR_TILE [--xy X,Y] [--size 256] [--out_prefix roi]
      [--device cpu]

Reads a region from an H&E WSI (or a tile file), runs the generator of the
checkpoint dir (``load_serving_model``: LoRA merged, bf16 on the card
through K1, K2 and K3; f32 on the CPU with ``--device cpu``), segments
nuclei on the predicted nuclear channel (cellpose when installed, else the
classical watershed: ``nuclei_segmentation.backends.get_backend("auto")``),
pools per-nucleus marker means (``metrics.cell.CellMetrics``), gates cells
with the checkpoint's ``logreg.npz`` head where there is one, and writes
``<prefix>_cells.csv`` and the predicted mIF ``<prefix>_mif.ome.tiff``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..config import load_yaml
from ..data.table import Table
from ..infer.tiles import load_serving_model, predictions_to_uint8
from ..metrics.cell import CellMetrics, LogRegHead
from ..preprocessings.nuclei_segmentation.backends import get_backend
from ..slideio import SlideReader, read_image, write_pyramid


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--input", required=True, help="H&E WSI or tile image file")
    parser.add_argument("--xy", default=None, help="x,y for WSI region reads")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--out_prefix", default="roi")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    cfg = load_yaml(str(Path(args.checkpoint_dir) / "config.yaml"))
    names = list(cfg.data.targ_channel_names)

    if args.xy:
        x0, y0 = (int(v) for v in args.xy.split(","))
        reader = SlideReader(args.input, mode="RGB")
        tile = reader.read_region((x0, y0), 0, (args.size, args.size))
        reader.close()
    else:
        tile = read_image(args.input)[:args.size, :args.size]

    device = resolve_device(args.device)
    model, he_norm = load_serving_model(cfg, args.checkpoint_dir, (args.size, args.size),
                                        len(names), device)
    with torch.inference_mode():
        pred = model(torch.from_numpy(np.asarray(he_norm(tile), np.float32))[None].to(device))
    pred = pred.float()

    mif_u8 = predictions_to_uint8(pred[0].cpu().numpy())
    write_pyramid(f"{args.out_prefix}_mif.ome.tiff", np.moveaxis(mif_u8, -1, 0), n_levels=2,
                  tile_size=256)

    # on-the-fly nuclei from the predicted nuclear channel (or DAPI-like ch 0)
    nuc_channel = 0
    labels = get_backend("auto")(mif_u8[..., nuc_channel])
    print(f"{labels.max()} nuclei segmented")

    slide_df = Table({"in_slide_name": ["roi"], "nuclei_csv_path": [None]})
    cm = CellMetrics(slide_df, names, min_area=20)
    cm.update(pred, torch.from_numpy(np.asarray(labels))[None], ["roi"])
    cells = cm.get_dataframe_cell_pred()

    logreg_npz = Path(args.checkpoint_dir) / "logreg.npz"
    if logreg_npz.exists():
        data = np.load(logreg_npz)
        head = LogRegHead(weight=data["weight"], bias=data["bias"])
        probs = head.predict_proba(np.stack([np.asarray(cells[c], np.float64)
                                             for c in cm.marker_pred_cols], axis=1))
        for i, col in enumerate(cm.marker_cols):
            cells = cells.replace(f"{col}_logreg", probs[:, i] > 0.5)
    cells.to_csv(f"{args.out_prefix}_cells.csv")
    print(f"wrote {args.out_prefix}_mif.ome.tiff and {args.out_prefix}_cells.csv "
          f"({len(cells)} cells)")


if __name__ == "__main__":
    main()
