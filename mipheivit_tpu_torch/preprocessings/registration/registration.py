"""H&E <-> mIF WSI registration and warped-nuclei transfer (the port's copy
of ``preprocessings/registration/registration.py``).

Usage:
  python -m mipheivit_tpu_torch.preprocessings.registration.registration
      --fixed_slide HE --moving_slide MIF --out_path O
      [--backend auto|valis|rigid] [--nuclei_slide N] [--nuclei_out NO]
      [--band_rows 2048]

``--backend valis`` drives Valis (non-rigid, JVM) when the package is
installed, as the reference does; ``rigid`` finds one translation by phase
correlation on thumbnails and streams the shifted moving slide onto the
fixed slide's grid in full-width row bands through ``PyramidWriter``. The
same integer shift applied to the nuclei label slide is the
nearest-interpolation label transfer. Host only (cv2).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...slideio import PyramidWriter, SlideReader, build_ome_xml


def _gray(img: np.ndarray) -> np.ndarray:
    import cv2

    if img.ndim == 3 and img.shape[-1] == 3:
        return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
    return img[..., 0].astype(np.float32)


def rigid_offset(fixed: np.ndarray, moving: np.ndarray):
    """Translation estimate via phase correlation on thumbnails."""
    import cv2

    f, m = _gray(fixed), _gray(moving)
    h = min(f.shape[0], m.shape[0])
    w = min(f.shape[1], m.shape[1])
    (dx, dy), _ = cv2.phaseCorrelate(f[:h, :w], m[:h, :w])
    return dx, dy


def warp_rigid_stream(moving: SlideReader, out_path: str, dims_wh, dx0: float, dy0: float,
                      mpp: float, band_rows: int = 2048) -> None:
    """Stream the translated moving slide onto the fixed slide's grid in
    full-width row bands (one band resident; out-of-bounds rows come back
    zero-padded from the reader)."""
    w, h = int(dims_wh[0]), int(dims_wh[1])
    n_ch = moving.n_channels
    names = moving.channel_names or [f"ch{i}" for i in range(n_ch)]
    dtype = moving.dtype if moving.dtype in (
        np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.int32),
        np.dtype(np.float32)) else np.dtype(np.uint8)
    xml = build_ome_xml(w, h, names, dtype.name, physical_size_um=mpp)
    with PyramidWriter(out_path, width=w, height=h, n_channels=n_ch, dtype=dtype,
                       n_levels=4, tile_size=512, mpp=mpp or 0.0, ome_xml=xml) as writer:
        for ty in range(0, h, band_rows):
            bh = min(band_rows, h - ty)
            band = moving.read_region((int(round(dx0)), int(round(ty + dy0))), 0, (w, bh))
            writer.write_band(np.moveaxis(band, -1, 0).astype(dtype))


def run_rigid(fixed_path: str, moving_path: str, out_path: str, nuclei_path: str = None,
              nuclei_out: str = None, band_rows: int = 2048):
    fixed = SlideReader(fixed_path, mode="RGB")
    moving = SlideReader(moving_path, mode="IF")
    f_thumb = fixed.get_thumbnail((1024, 1024))
    m_thumb = moving.get_thumbnail((1024, 1024))
    dx, dy = rigid_offset(f_thumb, m_thumb)
    scale = fixed.dimensions[0] / f_thumb.shape[1]
    dx0, dy0 = dx * scale, dy * scale
    print(f"rigid offset (level 0): dx={dx0:.1f}, dy={dy0:.1f}")

    warp_rigid_stream(moving, out_path, fixed.dimensions, dx0, dy0, fixed.mpp or 0.0,
                      band_rows=band_rows)
    print(f"registered mIF -> {out_path}")
    if nuclei_path:
        nuclei = SlideReader(nuclei_path, mode="IF")
        # an integer translation: the nearest-interpolation warp of the
        # labels is the same shifted read
        warp_rigid_stream(nuclei, nuclei_out, fixed.dimensions, dx0, dy0, fixed.mpp or 0.0,
                          band_rows=band_rows)
        nuclei.close()
        print(f"warped nuclei -> {nuclei_out}")
    fixed.close()
    moving.close()
    return dx0, dy0


def run_valis(fixed_path: str, moving_path: str, out_dir: str, nuclei_path: str = None):
    """Drive Valis as the reference script does: register the pair towards
    the fixed slide, warp and save the moving slide, and transfer nuclei
    labels with nearest interpolation."""
    import shutil
    import tempfile

    from valis import registration as valis_reg
    from valis import slide_io

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    src_dir = Path(tempfile.mkdtemp(prefix="valis_src_"))
    for p in (fixed_path, moving_path):
        (src_dir / Path(p).name).symlink_to(Path(p).resolve())
    try:
        registrar = valis_reg.Valis(str(src_dir), str(out_dir), reference_img_f=fixed_path,
                                    align_to_reference=False)
        registrar.register()
        registrar.warp_and_save_slides(str(out_dir), crop="overlap")
        if nuclei_path:
            slide_obj = registrar.get_slide(moving_path)
            dst_f = str(out_dir / (Path(nuclei_path).stem + ".tiff"))
            slide_obj.warp_and_save_slide(
                dst_f=dst_f, level=0, non_rigid=True, crop=True, src_f=nuclei_path,
                interp_method="nearest", compression=valis_reg.DEFAULT_COMPRESSION,
                channel_names=slide_io.get_slide_reader(nuclei_path)(
                    nuclei_path).metadata.channel_names,
                Q=100, pyramid=True)
        valis_reg.kill_jvm()
    finally:
        shutil.rmtree(src_dir, ignore_errors=True)
    print(f"valis registration -> {out_dir}")


def default_nuclei_out(out_path: str) -> str:
    """``<out stem>_nuclei.ome.tiff`` beside ``out_path``."""
    stem = Path(out_path).name
    for suf in (".ome.tiff", ".ome.tif", ".tiff", ".tif"):
        if stem.endswith(suf):
            stem = stem[:-len(suf)]
            break
    return str(Path(out_path).parent / (stem + "_nuclei.ome.tiff"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--fixed_slide", required=True, help="H&E WSI")
    parser.add_argument("--moving_slide", required=True, help="mIF WSI")
    parser.add_argument("--out_path", required=True,
                        help="output WSI path (rigid) or directory (valis)")
    parser.add_argument("--backend", default="auto", choices=["auto", "valis", "rigid"])
    parser.add_argument("--nuclei_slide", default=None,
                        help="nuclei label WSI to transfer with the same warp")
    parser.add_argument("--nuclei_out", default=None)
    parser.add_argument("--band_rows", type=int, default=2048)
    args = parser.parse_args(argv)

    if args.backend in ("auto", "valis"):
        try:
            import valis  # noqa: F401

            run_valis(args.fixed_slide, args.moving_slide, args.out_path, args.nuclei_slide)
            return
        except ImportError:
            if args.backend == "valis":
                raise

    nuclei_out = args.nuclei_out
    if args.nuclei_slide and not nuclei_out:
        nuclei_out = default_nuclei_out(args.out_path)
    run_rigid(args.fixed_slide, args.moving_slide, args.out_path, args.nuclei_slide,
              nuclei_out, band_rows=args.band_rows)


if __name__ == "__main__":
    main()
