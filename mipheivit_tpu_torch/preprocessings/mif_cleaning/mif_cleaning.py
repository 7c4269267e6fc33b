"""mIF WSI cleaning: autofluorescence subtraction and log1p / p99
quantisation on the card (the port's copy of
``preprocessings/mif_cleaning/mif_cleaning.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.mif_cleaning.mif_cleaning
      --slide_path S --out_path O --lambda_settings J --channel_names A,B,...
      [--af_channel 0] [--tile_size 2048] [--band_rows 256]
      [--artifact_channel_name N] [--artifact_threshold 2000] [--device cpu]

Two passes, both in torch on the card unless ``--device cpu`` is given
(without a card it raises; nothing runs on the CPU unasked):

  pass 1: per-channel 4096-bin histograms over Otsu-tissue tiles (at most
    ``max_tiles``, drawn with ``default_rng(seed).choice`` as the JAX
    script draws them) of ``max(ch - lambda * AF + bias, 0)``, leaving out
    zeros and pixels whose artifact channel is at or above the threshold.
    The bins are ``np.histogram``'s: the f32 values, upcast to f64, are
    bucketed against the same f64 edges (half-open, the last bin closed),
    so the counts and the p99 bins equal the JAX script's.
  pass 2: every full-width row band as
    ``uint8(clip(log1p(x / p99), 0, 1) * 255)``, streamed through
    ``PyramidWriter``. The arithmetic keeps numpy's order in f32; the
    device's ``log1p`` may differ from numpy's by one ulp, which moves a
    pixel one uint8 step where the product sits on a step's edge.

Each band is read on the host, uploaded as uint16 through pinned memory,
computed on the device and fetched as uint8; ``main`` prints the slide's
Mpx/s over both passes and the read / upload / device / write seconds.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..._device import resolve_device
from ...slideio import PyramidWriter, SlideReader, build_ome_xml, get_locs_otsu
from ..stages import StageClock


def af_subtract(tile: torch.Tensor, af: torch.Tensor, lam, bias) -> torch.Tensor:
    """``max((tile - lam * af) + bias, 0)`` in f32, numpy's order."""
    return torch.clamp_min(tile.float() - lam * af.float() + bias, 0.0)


def settings_vectors(settings: dict, n_ch: int, af_channel: int):
    """Per-channel (lambda, bias) vectors; the AF channel gets lambda 0."""
    lam = np.zeros(n_ch, np.float32)
    bias = np.zeros(n_ch, np.float32)
    for c in range(n_ch):
        ch_cfg = settings.get(str(c), {})
        lam[c] = float(ch_cfg.get("lambda", 0.0)) if c != af_channel else 0.0
        bias[c] = float(ch_cfg.get("bias", 0.0))
    return lam, bias


def find_percentile_bin(hist: np.ndarray, bin_edges: np.ndarray, pct: float = 99.0) -> float:
    """The upper edge of the bin holding the ``pct`` percentile of an
    accumulated histogram."""
    cdf = np.cumsum(hist)
    if cdf[-1] == 0:
        return 1.0
    cutoff = cdf[-1] * pct / 100.0
    idx = int(np.searchsorted(cdf, cutoff))
    return float(bin_edges[min(idx + 1, len(bin_edges) - 1)])


def tile_histograms(tile: torch.Tensor, lam: torch.Tensor, bias: torch.Tensor,
                    af_channel: int, edges: torch.Tensor, artifact_channel: int = None,
                    artifact_threshold: float = 2000.0) -> torch.Tensor:
    """``[C, n_bins]`` int64 counts of one ``[H, W, C]`` tile's cleaned
    values, as ``np.histogram(vals, bins=edges)`` counts each channel."""
    n_ch = tile.shape[-1]
    n_bins = edges.numel() - 1
    clean = af_subtract(tile, tile[..., af_channel:af_channel + 1], lam, bias)
    keep = clean > 0
    if artifact_channel is not None:
        keep &= tile[..., artifact_channel:artifact_channel + 1].float() < artifact_threshold
    wide = clean.double()
    b = torch.bucketize(wide, edges, right=True) - 1          # edges[b] <= x < edges[b + 1]
    b = torch.where(wide == edges[-1], n_bins - 1, b)          # the last bin is closed
    keep &= (b >= 0) & (b < n_bins)
    offsets = torch.arange(n_ch, device=tile.device) * n_bins
    idx = torch.where(keep, b + offsets, n_ch * n_bins)        # the rest into a spare slot
    return torch.bincount(idx.reshape(-1), minlength=n_ch * n_bins + 1)[:-1].view(n_ch, n_bins)


def extract_histograms(reader: SlideReader, settings: dict, af_channel: int,
                       tile_size: int = 2048, n_bins: int = 4096,
                       value_range: float = 65535.0, mask_thresh: float = 0.05,
                       artifact_channel: int = None, artifact_threshold: float = 2000.0,
                       max_tiles: int = 500, seed: int = 42, device=None,
                       clock: StageClock = None):
    """Pass 1: per-channel histograms of the AF-subtracted tissue signal,
    ``(hists [C, n_bins] int64, edges [n_bins + 1] f64)`` as numpy."""
    device = resolve_device(device)
    clock = clock or StageClock(device)
    with clock.stage("read"):
        thumb = reader.get_thumbnail((1024, 1024))
    locs, _ = get_locs_otsu(thumb, reader.dimensions, tile_size, mask_thresh=mask_thresh)
    if len(locs) > max_tiles:
        keep = np.random.default_rng(seed).choice(len(locs), max_tiles, replace=False)
        locs = locs[keep]
    n_ch = reader.n_channels
    lam, bias = (torch.from_numpy(v).to(device)
                 for v in settings_vectors(settings, n_ch, af_channel))
    edges = np.linspace(0, value_range, n_bins + 1)
    edges_d = torch.from_numpy(edges).to(device)
    hists = torch.zeros((n_ch, n_bins), dtype=torch.int64, device=device)
    for (tx, ty) in locs:
        with clock.stage("read"):
            tile = reader.read_region((int(tx), int(ty)), 0, (tile_size, tile_size))
        tile = clock.upload(tile)
        with clock.stage("device"):
            hists += tile_histograms(tile, lam, bias, af_channel, edges_d, artifact_channel,
                                     artifact_threshold)
    with clock.stage("device"):
        hists = hists.cpu().numpy()
    return hists, edges


def quantize_band(band: torch.Tensor, lam: torch.Tensor, bias: torch.Tensor,
                  af_channel: int, p99: torch.Tensor) -> torch.Tensor:
    """``uint8(clip(log1p(clean / p99), 0, 1) * 255)`` of an ``[H, W, C]``
    band, as ``[C, H, W]``."""
    clean = af_subtract(band, band[..., af_channel:af_channel + 1], lam, bias)
    q = torch.clip(torch.log1p(clean / p99), 0.0, 1.0) * 255.0
    return q.to(torch.uint8).permute(2, 0, 1).contiguous()


def apply_cleaning_wsi(reader: SlideReader, settings: dict, af_channel: int, p99,
                       out_path: str, channel_names, band_rows: int = 256, device=None,
                       clock: StageClock = None):
    """Pass 2: the whole slide quantised to uint8 in full-width row bands,
    one band resident on each side, streamed through the pyramid writer."""
    device = resolve_device(device)
    clock = clock or StageClock(device)
    w, h = reader.dimensions
    n_ch = reader.n_channels
    lam, bias = (torch.from_numpy(v).to(device)
                 for v in settings_vectors(settings, n_ch, af_channel))
    p99 = torch.from_numpy(np.asarray(p99, np.float32).reshape(n_ch)).to(device)
    xml = build_ome_xml(w, h, channel_names, "uint8", physical_size_um=reader.mpp)
    writer = PyramidWriter(out_path, width=w, height=h, n_channels=n_ch, dtype=np.uint8,
                           n_levels=4, tile_size=512, mpp=reader.mpp or 0.0, ome_xml=xml)
    try:
        for ty in range(0, h, band_rows):
            bh = min(band_rows, h - ty)
            with clock.stage("read"):
                band = reader.read_region((0, ty), 0, (w, bh))
            band = clock.upload(band)
            with clock.stage("device"):
                q = quantize_band(band, lam, bias, af_channel, p99).cpu().numpy()
            with clock.stage("write"):
                writer.write_band(q)
    except BaseException:
        writer.abort()
        raise
    with clock.stage("write"):              # the tiles and levels, compressed, at close
        writer.close()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_path", required=True)
    parser.add_argument("--out_path", required=True)
    parser.add_argument("--lambda_settings", required=True,
                        help="JSON: {channel_idx: {lambda, bias}}")
    parser.add_argument("--af_channel", type=int, default=0)
    parser.add_argument("--channel_names", required=True)
    parser.add_argument("--tile_size", type=int, default=2048)
    parser.add_argument("--band_rows", type=int, default=256)
    parser.add_argument("--artifact_channel_name", default=None,
                        help="channel whose bright pixels mark imaging artifacts")
    parser.add_argument("--artifact_threshold", type=float, default=2000.0)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    settings = json.loads(Path(args.lambda_settings).read_text())
    names = args.channel_names.split(",")
    artifact_channel = (names.index(args.artifact_channel_name)
                        if args.artifact_channel_name else None)
    clock = StageClock(device)
    t0 = time.perf_counter()
    reader = SlideReader(args.slide_path, mode="IF")
    hists, edges = extract_histograms(
        reader, settings, args.af_channel, args.tile_size, artifact_channel=artifact_channel,
        artifact_threshold=args.artifact_threshold, device=device, clock=clock)
    p99 = np.array([find_percentile_bin(hists[c], edges) for c in range(reader.n_channels)])
    print("p99 per channel:", np.round(p99, 1))
    # --tile_size sets pass 1's sampled tiles only; pass 2 streams
    # full-width bands of --band_rows
    apply_cleaning_wsi(reader, settings, args.af_channel, p99, args.out_path, names,
                       band_rows=args.band_rows, device=device, clock=clock)
    w, h = reader.dimensions
    reader.close()
    wall = time.perf_counter() - t0
    mpx = w * h / 1e6
    print(f"cleaned WSI -> {args.out_path}: {mpx:.1f} Mpx in {wall:.3f} s on {device} "
          f"({mpx / wall:.2f} Mpx/s over both passes; {clock.text()})")
    return {"p99": p99, "hists": hists, "wall_s": wall, "mpx_per_s": mpx / wall,
            "split": dict(clock.seconds)}


if __name__ == "__main__":
    main()
