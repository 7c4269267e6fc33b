"""WSI-scale nucleus segmentation with cross-tile label merging (the port's
copy of ``preprocessings/nuclei_segmentation/wsi_nuclei_inference.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.nuclei_segmentation.wsi_nuclei_inference
      --slide_path S --out_path O [--backend auto|cellpose|classical|torch]
      [--cellpose_ckpt C] [--flow_averaging] [--device cpu]

Reference: preprocessings/nuclei_segmentation/nuclei_dapi_wsi_cellpose/
cellpose_wsi_inference.py. The DAPI channel is rescaled to ~0.325 mpp
(:133,152-154) and tiled with a halo; each tile is segmented and only the
instances the tile's interior owns are kept (:225-249); ids are offset by
the running maximum, relabelled sequentially (:253-256), expanded by
~1/mpp px (:258-274) and written as a 2-channel (labels int32, boundaries)
pyramidal OME-TIFF (:278-305).

``--backend torch`` runs the port's CPnet (``--cellpose_ckpt``) on the card
unless ``--device cpu`` is given; without a card it raises. Memory is
bounded as the reference bounds it: the labels plane is a disk-backed
``np.memmap`` (``--scratch_path``), the relabel walks it in row bands, and
the pyramid (expansion and boundaries applied band-wise with a halo)
streams through ``PyramidWriter``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...slideio import PyramidWriter, SlideReader, build_ome_xml
from .backends import expand_labels, find_boundaries, get_backend

MPP_TARGET = 0.325  # reference: cellpose_wsi_inference.py:133


def _read_scaled(reader, x0: int, y0: int, tw: int, th: int, scale: float) -> np.ndarray:
    """A tile of the virtually rescaled slide (dims * scale): the native
    region under it, resized (the reference resizes the whole slide through
    pyvips at :152-154; here per tile, so RAM stays tile-bounded)."""
    if scale == 1.0:
        return reader.read_region((x0, y0), 0, (tw, th))
    import cv2

    nx0, ny0 = int(round(x0 / scale)), int(round(y0 / scale))
    nw = max(int(round(tw / scale)), 1)
    nh = max(int(round(th / scale)), 1)
    native = reader.read_region((nx0, ny0), 0, (nw, nh))
    interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_LINEAR
    out = cv2.resize(native, (tw, th), interpolation=interp)
    if out.ndim == 2:
        out = out[..., None]
    return out


def _banded_unique(labels: np.ndarray, band_rows: int = 4096) -> np.ndarray:
    """``np.unique`` without a sorted copy of the whole plane."""
    uniq = np.array([], np.int32)
    for y in range(0, labels.shape[0], band_rows):
        uniq = np.union1d(uniq, np.unique(np.asarray(labels[y:y + band_rows])))
    return uniq[uniq > 0]


def merge_owned_instances(labels, tile_labels, tx, ty, x0, y0, x1, y1, tile_size: int,
                          next_id: int, vh: int, vw: int) -> int:
    """Keep the instances whose pixels fall mostly inside the halo-free core,
    give them globally unique ids and write them into the labels plane
    (reference merge rule: cellpose_wsi_inference.py:225-249). Returns the
    next free id."""
    core = np.zeros_like(tile_labels, bool)
    core[ty - y0: min(ty + tile_size, vh) - y0, tx - x0: min(tx + tile_size, vw) - x0] = True
    keep = []
    for lab in np.unique(tile_labels[tile_labels > 0]):
        mask = tile_labels == lab
        if mask[core].sum() * 2 >= mask.sum():
            keep.append(lab)
    if not keep:
        return next_id
    remap = np.zeros(int(tile_labels.max()) + 1, np.int32)
    for j, lab in enumerate(keep):
        remap[lab] = next_id + j + 1
    owned = remap[tile_labels]
    region = labels[y0:y1, x0:x1]
    region[owned > 0] = owned[owned > 0]
    labels[y0:y1, x0:x1] = region
    return next_id + len(keep)


def sequential_relabel(labels, next_id: int, band: int = 4096) -> None:
    """Compact the ids to 1..N in place, band by band."""
    uniq = _banded_unique(labels)
    lut = np.zeros(next_id + 1, np.int32)
    lut[uniq] = np.arange(1, len(uniq) + 1, dtype=np.int32)
    for y in range(0, labels.shape[0], band):
        labels[y:y + band] = lut[np.asarray(labels[y:y + band])]


def _virtual_size(reader, target_mpp):
    w, h = reader.dimensions
    scale = reader.mpp / float(target_mpp) if target_mpp and reader.mpp else 1.0
    return scale, max(int(round(w * scale)), 1), max(int(round(h * scale)), 1)


def segment_wsi(reader, segment_fn, tile_size: int = 2048, halo: int = 128, dapi_channel=0,
                scratch_path: str = None, target_mpp: float = None) -> np.ndarray:
    """Tiles of ``tile_size`` with a ``halo`` through ``segment_fn``; the
    owned instances merged into one plane. ``dapi_channel``: the channel
    handed to ``segment_fn`` (None: the whole HWC tile, for H&E).
    ``target_mpp``: segment a virtual rescale of the slide to that
    resolution; the plane has the rescaled size. Returns the sequentially
    relabelled int32 plane, an ``np.memmap`` when ``scratch_path`` is
    given."""
    scale, vw, vh = _virtual_size(reader, target_mpp)
    if scratch_path:
        labels = np.memmap(scratch_path, dtype=np.int32, mode="w+", shape=(vh, vw))
    else:
        labels = np.zeros((vh, vw), np.int32)
    next_id = 0
    for ty in range(0, vh, tile_size):
        for tx in range(0, vw, tile_size):
            x0, y0 = max(tx - halo, 0), max(ty - halo, 0)
            x1, y1 = min(tx + tile_size + halo, vw), min(ty + tile_size + halo, vh)
            tile = _read_scaled(reader, x0, y0, x1 - x0, y1 - y0, scale)
            tile_labels = segment_fn(tile if dapi_channel is None else tile[..., dapi_channel])
            next_id = merge_owned_instances(labels, tile_labels, tx, ty, x0, y0, x1, y1,
                                            tile_size, next_id, vh, vw)
    sequential_relabel(labels, next_id)
    return labels


def stream_labels_pyramid(labels: np.ndarray, out_path: str, mpp: float,
                          expansion_px: float = 0.0, band_rows: int = 2048) -> None:
    """Write the (labels, boundaries) pyramid in row bands; expansion and
    boundaries run per band with a halo wide enough that the result equals
    a whole-plane pass."""
    h, w = labels.shape
    halo = int(np.ceil(expansion_px)) + 2
    xml = build_ome_xml(w, h, ["nuclei", "boundaries"], "int32", physical_size_um=mpp)
    with PyramidWriter(out_path, width=w, height=h, n_channels=2, dtype=np.int32, n_levels=4,
                       tile_size=512, mpp=mpp or 0.0, ome_xml=xml) as writer:
        for y in range(0, h, band_rows):
            bh = min(band_rows, h - y)
            y0, y1 = max(y - halo, 0), min(y + bh + halo, h)
            ext = np.asarray(labels[y0:y1])
            if expansion_px > 0:
                ext = expand_labels(ext, expansion_px)
            bnd = find_boundaries(ext)
            s = y - y0
            writer.write_band(np.stack([ext[s:s + bh], bnd[s:s + bh]]).astype(np.int32))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_path", required=True)
    parser.add_argument("--out_path", required=True)
    parser.add_argument("--backend", default="auto",
                        choices=["auto", "cellpose", "classical", "torch"],
                        help="'torch' = the port's CPnet on the card (needs --cellpose_ckpt)")
    parser.add_argument("--cellpose_ckpt", default=None,
                        help="Cellpose torch checkpoint for --backend torch "
                             "(reference: cellpose_wsi_inference.py:148)")
    parser.add_argument("--device", default=None,
                        help="where --backend torch runs the network (default: the card)")
    parser.add_argument("--dapi_channel", type=int, default=0)
    parser.add_argument("--tile_size", type=int, default=2048)
    parser.add_argument("--halo", type=int, default=128)
    parser.add_argument("--expansion_px", type=float, default=3.0)
    parser.add_argument("--target_mpp", type=float, default=MPP_TARGET,
                        help="segment at this resolution (reference :133); 0: native")
    parser.add_argument("--scratch_path", default=None,
                        help="disk-backed labels plane (default: next to out_path)")
    parser.add_argument("--flow_averaging", action="store_true",
                        help="Cellpose flow-field overlap averaging (reference "
                             "cellpose_wsi_inference.py:161-249): the CPnet with --backend "
                             "torch, else cellpose when installed, else the flow dynamics "
                             "over the classical segmenter's per-tile masks")
    args = parser.parse_args(argv)

    if args.backend == "torch" and not args.cellpose_ckpt:
        parser.error("--backend torch requires --cellpose_ckpt")
    reader = SlideReader(args.slide_path, mode="IF")
    scratch = args.scratch_path or (args.out_path + ".labels.raw")
    if args.flow_averaging:
        from . import flow_wsi

        try:
            if args.backend == "torch":
                flow_fn, masks_fn = flow_wsi.cellpose_torch_flow_factory(
                    args.cellpose_ckpt, device=args.device)
            else:
                flow_fn, masks_fn = flow_wsi.cellpose_flow_factory()
        except ImportError:
            # network-free flow averaging: the classical per-tile masks become
            # Cellpose diffusion flows, averaged over the tile overlaps and
            # segmented again by flow following
            from .flow_dynamics import reference_dynamics_factory

            print("cellpose not installed: flow averaging over the classical segmenter "
                  "(flow_dynamics.py)")
            flow_fn, masks_fn = reference_dynamics_factory(get_backend("classical"))
        labels = flow_wsi.flow_segment_wsi(
            reader, flow_fn, masks_fn, tile_size=args.tile_size, overlap=args.halo,
            dapi_channel=args.dapi_channel,
            scratch_dir=str(Path(scratch).parent / "flow_scratch"),
            target_mpp=args.target_mpp or None)
    else:
        segment_fn = get_backend(args.backend, cellpose_ckpt=args.cellpose_ckpt,
                                 device=args.device)
        labels = segment_wsi(reader, segment_fn, args.tile_size, args.halo, args.dapi_channel,
                             scratch_path=scratch, target_mpp=args.target_mpp or None)
    out_mpp = (args.target_mpp or reader.mpp) if reader.mpp else 0.0
    stream_labels_pyramid(labels, args.out_path, out_mpp, args.expansion_px)
    n = int(labels.max())
    if args.flow_averaging:
        from .flow_wsi import cleanup_flow_scratch

        cleanup_flow_scratch(labels)
    else:
        del labels
    Path(scratch).unlink(missing_ok=True)
    reader.close()
    print(f"{n} nuclei -> {args.out_path}")
    return n


if __name__ == "__main__":
    main()
