"""slideio: whole-slide image IO (the native-code layer of the framework).

The port's own copy of ``mipheivit_tpu/slideio`` (the port imports nothing
of the JAX package); the native engine builds at first use into the
package's ``build/`` directory.

C++ engine on libtiff (native/slidetiff.cpp) + thin Python facade:
  * ``SlideReader`` — pyramid open, padded region reads (slidevips parity)
  * ``write_pyramid`` / ``build_ome_xml`` — tiled pyramidal OME-TIFF output
  * ``get_locs_otsu`` — tissue tiling
  * ``resize`` — ``cv2.resize`` for any number of channels
  * ``read_image`` — small-tile decode dispatch (jpeg/png via cv2,
    tiff via the native engine, npy via numpy: the tile format that needs
    neither cv2 nor libtiff)
"""

from .ome import build_ome_xml, parse_channel_names
from .reader import SlideReader, SlideVips, resize
from .tiffio import PyramidWriter, TiffSlide, write_pyramid
from .tiling import get_locs_otsu, order_tiles_horizontally


def read_image(path, channel_idxs=None):
    """Decode a tile file (TIFF, PNG/JPEG, or an HWC or HW ``.npy`` array)
    into an HWC numpy array."""
    import numpy as np
    from pathlib import Path

    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        arr = np.load(path)
        if arr.ndim == 2:
            arr = arr[..., None]
    elif suffix in (".tif", ".tiff"):
        ts = TiffSlide(str(path))
        try:
            w, h = ts.dimensions
            arr = ts.read_region((0, 0), 0, (w, h))
        finally:
            ts.close()
    else:
        import cv2

        arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise IOError(f"cannot read {path}")
        if arr.ndim == 3 and arr.shape[-1] == 3:
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        elif arr.ndim == 2:
            arr = arr[..., None]
    if channel_idxs is not None:
        arr = arr[..., list(channel_idxs)]
    return arr


__all__ = [
    "PyramidWriter", "SlideReader", "SlideVips", "TiffSlide", "write_pyramid",
    "build_ome_xml", "parse_channel_names", "get_locs_otsu",
    "order_tiles_horizontally", "read_image", "resize",
]
