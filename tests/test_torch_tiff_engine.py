"""The port's TIFF engine (``slideio/native/slidetiff.cpp`` on libtiff): a
pyramid written by ``write_pyramid`` reads back bit for bit at every dtype
it writes, level 0 also through Pillow's own TIFF decoder and the reduced
levels against a numpy model of the engine's 2x reduction; the streaming
writer; classic stripped files from another writer; the build against
Pillow's bundled libtiff (the card machine's only libtiff); and a build
that cannot find libtiff raising instead of serving anything else."""

import numpy as np
import pytest
from PIL import Image

from mipheivit_tpu_torch.slideio import PyramidWriter, TiffSlide, tiffio
from mipheivit_tpu_torch.slideio.native import build as native_build

DTYPES = [np.uint8, np.uint16, np.int32, np.float32]
XML = '<?xml version="1.0"?><OME><Image ID="Image:0"/></OME>'


def _planes(dtype, c, h=101, w=77, seed=0):
    g = np.random.default_rng(seed)
    if dtype == np.float32:
        return g.standard_normal((c, h, w)).astype(np.float32)
    return g.integers(0, np.iinfo(dtype).max // 2, (c, h, w)).astype(dtype)


def _down2x(plane):
    """The engine's level reduction (``down2x_rows``): the floor of the
    2x2 mean for 8/16-bit, the f32 mean summed in the engine's order, the
    top-left sample for 32-bit integer label planes."""
    h, w = plane.shape[0] // 2, plane.shape[1] // 2
    a, b = plane[0:2 * h:2, 0:2 * w:2], plane[0:2 * h:2, 1:2 * w:2]
    c, d = plane[1:2 * h:2, 0:2 * w:2], plane[1:2 * h:2, 1:2 * w:2]
    if plane.dtype == np.int32:
        return a.copy()
    if plane.dtype == np.float32:
        return (((a + b) + c) + d) / np.float32(4)
    s = a.astype(np.uint32) + b + c + d
    return (s // 4).astype(plane.dtype)


def _pyramid(slide):
    """Every level of ``slide`` read whole, with its metadata."""
    levels = [slide.read_region((0, 0), lvl, slide.level_dimensions[lvl])
              for lvl in range(slide.n_levels)]
    meta = (slide.n_channels, slide.n_levels, slide.dtype, slide.level_dimensions, slide.mpp,
            slide.description)
    return levels, meta


def _same(a, b):
    (la, ma), (lb, mb) = a, b
    assert ma == mb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("c", [1, 3])
def test_pyramid_round_trip(tmp_path, dtype, c):
    """write_pyramid then TiffSlide: every level bit for bit (3 levels, odd
    sizes, edge tiles), level 0 also as Pillow decodes each channel's page,
    mpp and the OME-XML kept, an out-of-bounds region zero-padded."""
    data = _planes(dtype, c)
    path = str(tmp_path / "p.tiff")
    tiffio.write_pyramid(path, data, n_levels=3, tile_size=32, mpp=0.5, ome_xml=XML)
    slide = TiffSlide(path)
    levels, (n_ch, n_lv, dt, dims, mpp, desc) = _pyramid(slide)
    tile = slide.read_region((60, 90), 0, (40, 40))
    slide.close()
    assert (n_ch, n_lv, dims, dt) == (c, 3, [(77, 101), (38, 50), (19, 25)], np.dtype(dtype))
    assert mpp == pytest.approx(0.5) and desc == XML
    want = data
    for got in levels:
        np.testing.assert_array_equal(got, want.transpose(1, 2, 0))
        want = np.stack([_down2x(p) for p in want])
    with Image.open(path) as im:
        for ch in range(c):
            im.seek(ch)
            np.testing.assert_array_equal(np.asarray(im).astype(dtype), data[ch])
    np.testing.assert_array_equal(tile[:11, :17], data[:, 90:, 60:].transpose(1, 2, 0))
    assert not tile[11:].any() and not tile[:, 17:].any()


def test_streaming_writer_equals_whole_write(tmp_path):
    """PyramidWriter fed row bands writes the pixels ``write_pyramid``
    writes from the whole array, and leaves no spill behind."""
    data = _planes(np.int32, 2, 130, 90)
    whole, banded = str(tmp_path / "w.tiff"), str(tmp_path / "b.tiff")
    tiffio.write_pyramid(whole, data, n_levels=4, tile_size=32, mpp=0.325)
    with PyramidWriter(banded, width=90, height=130, n_channels=2, dtype=np.int32,
                       n_levels=4, tile_size=32, mpp=0.325, ome_xml="") as w:
        for y in range(0, 130, 48):
            w.write_band(data[:, y:y + 48])
    _same(_pyramid(TiffSlide(whole)), _pyramid(TiffSlide(banded)))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["b.tiff", "w.tiff"]


@pytest.mark.parametrize("compression", [1, 8])
def test_classic_stripped_tiff(tmp_path, compression):
    """A classic (not BigTIFF) stripped RGB file from another writer reads
    back as written."""
    cv2 = pytest.importorskip("cv2")
    img = _planes(np.uint8, 3, 45, 61).transpose(1, 2, 0).copy()
    path = str(tmp_path / "classic.tif")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
    with open(path, "rb") as f:
        assert f.read(4) in (b"II*\0", b"MM\0*")
    slide = TiffSlide(path)
    assert (slide.n_channels, slide.n_levels, slide.dimensions) == (3, 1, (61, 45))
    np.testing.assert_array_equal(slide.read_region((0, 0), 0, (61, 45))[..., ::-1], img)
    slide.close()


def test_native_engine_builds_against_pillows_libtiff(tmp_path, monkeypatch):
    """Without a system libtiff, the engine links the copy Pillow's wheel
    ships (``pillow.libs/libtiff-<hash>.so*``) and reads what the engine on
    the system's libtiff wrote, bit for bit."""
    data = _planes(np.uint16, 2, 80, 60)
    path = str(tmp_path / "p.tiff")
    tiffio.write_pyramid(path, data, n_levels=2, tile_size=32, mpp=0.25)
    want = _pyramid(TiffSlide(path))
    monkeypatch.setattr(native_build, "_SYSTEM", ())
    lib = native_build.find_libtiff()
    assert lib is not None and "pillow.libs" in lib
    monkeypatch.setattr(native_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tiffio._Lib, "_lib", None)
    slide = TiffSlide(path)
    _same(_pyramid(slide), want)
    slide.close()
    assert [p.name.startswith("libslidetiff-") for p in (tmp_path / "build").iterdir()] == [True]


def test_engine_without_libtiff_raises(tmp_path, monkeypatch):
    """No libtiff to link: opening or writing a slide raises, naming what
    is missing; nothing else serves in its place."""
    monkeypatch.setattr(native_build, "_SYSTEM", ())
    monkeypatch.setattr(native_build, "_site_dirs", lambda: [str(tmp_path)])
    monkeypatch.setattr(native_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tiffio._Lib, "_lib", None)
    with pytest.raises(RuntimeError, match="no libtiff runtime"):
        TiffSlide(str(tmp_path / "missing.tiff"))
    with pytest.raises(RuntimeError, match="no libtiff runtime"):
        tiffio.write_pyramid(str(tmp_path / "x.tiff"), _planes(np.uint8, 1, 8, 8))
