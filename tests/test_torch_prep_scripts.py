"""The port's data-preparation scripts against the JAX package's, on the CPU.

Each of the fifteen scripts that the port copies (slide scaling,
registration, the AF sweep, mIF cleaning, tiling, tile export, the tile
dataframe's marker columns, channel stats, target moments, the expression
matrix, artifact shares, OME-TIFF conversion, the HEMIT layout, the dataset
contact sheet, the foundation-free checkpoint) runs on the same seeded
slides through the JAX script (loaded from its file under a name of its
own; its ``main`` through ``sys.argv``) and through the port's module. What
must hold:

- pyramids equal bit for bit at every level, CSVs and JSONs equal as text
  (the f64 sums are the same numpy arithmetic, or integer sums, which f64
  adds exactly in any order);
- ``mif_cleaning``: pass 1's histograms and p99 bins equal; pass 2's
  uint8 pyramid within ``CLEAN_STEPS`` step of JAX's, on at most
  ``CLEAN_OFF_SHARE`` of its values (torch's ``log1p`` may differ from
  numpy's by one ulp; 0 measured here on this CPU);
- ``extract_expression_matrix``: the CSV equal at ``tile_size`` 8192 and
  at 200 px, where tiles cut nuclei;
- registration recovers a known shift within 2 px;
- ``mif_cleaning`` and ``extract_expression_matrix`` raise without a card
  unless ``--device cpu`` is given.

The ``gpu`` cases hold the card's two passes against the CPU's; they skip
here. Run them on a machine with a card (tests/conftest.py imports jax,
which that machine lacks; no JAX script is loaded by them):

    python -m pytest tests/test_torch_prep_scripts.py -m gpu --noconftest
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.data.table import Table
from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SIDE = 512                 # the seeded slides' side, px
N_CH = 17                  # AF (channel 0), 15 markers, an artifact channel (16)
MPP = 0.5
CLEAN_STEPS = 1
CLEAN_OFF_SHARE = 1e-4
NAMES = ["AF"] + [f"m{i}" for i in range(1, N_CH - 1)] + ["ART"]
SETTINGS = {str(c): {"lambda": 0.1 * (c % 4), "bias": float(25 * (c % 3))}
            for c in range(1, N_CH)}


def jax_script(rel: str):
    """The repo's script at ``rel``, loaded from its file under a name of
    its own (``tiling`` or ``registration`` would clash across files)."""
    name = "jaxprep_" + rel.replace("/", "_")[:-3]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REPO / rel)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def run_jax_main(rel: str, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [rel] + [str(a) for a in argv])
    jax_script(rel).main()


def make_slides(root: Path, seed: int = 0, side: int = SIDE) -> dict:
    """An H&E slide with a disc of tissue, a 17-channel uint16 mIF slide
    (AF leaking into the markers, saturated and artifact patches) and an
    int32 nuclei slide of discs with scattered ids up to 1e7."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:side, :side]
    tissue = (yy - side / 2) ** 2 + (xx - side / 2) ** 2 < (0.38 * side) ** 2
    he = np.full((3, side, side), 240, np.uint8)
    he[:, tissue] = rng.integers(40, 220, (3, int(tissue.sum())), dtype=np.uint8)
    af = np.where(tissue, rng.integers(300, 3000, (side, side)), rng.integers(0, 40, (side, side)))
    mif = np.zeros((N_CH, side, side), np.float64)
    mif[0] = af
    for c in range(1, N_CH):
        signal = rng.gamma(1.5, 300 * c, (side, side)) * tissue
        mif[c] = signal + 0.1 * (c % 4) * af + rng.integers(0, 30, (side, side))
    mif[5, 200:232, 200:232] = 65535              # saturated: the closed last bin
    mif[16] = rng.integers(0, 500, (side, side))
    mif[16, 300:340, 150:260] = 4000              # an artifact patch
    mif = np.clip(np.rint(mif), 0, 65535).astype(np.uint16)
    nuclei = np.zeros((1, side, side), np.int32)
    ids = rng.choice(10 ** 7, 400, replace=False) + 1
    for lab in ids:
        cy, cx = rng.integers(0, side, 2)
        r = rng.integers(4, 9)
        nuclei[0, (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = lab
    paths = {}
    for name, arr in (("he", he), ("mif", mif), ("nuclei", nuclei)):
        paths[name] = str(root / f"{name}.tiff")
        write_pyramid(paths[name], arr, n_levels=2, tile_size=128, mpp=MPP)
    return paths


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep_slides")
    return make_slides(root), root


def pyramid(path):
    ts = TiffSlide(str(path))
    try:
        meta = (ts.n_levels, ts.level_dimensions, ts.dtype, ts.mpp, ts.n_channels)
        levels = [ts.read_region((0, 0), lvl, ts.level_dimensions[lvl])
                  for lvl in range(ts.n_levels)]
    finally:
        ts.close()
    return meta, levels


def assert_same_pyramid(got, want):
    (gm, gl), (wm, wl) = pyramid(got), pyramid(want)
    assert gm == wm
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(a, b)


def assert_same_text(got, want, replace=()):
    g, w = Path(got).read_text(), Path(want).read_text()
    for old, new in replace:
        g = g.replace(old, new)
    assert g == w


# ---- row 1: scale_slides ------------------------------------------------------

@pytest.mark.parametrize("target_mpp", [1.0, 0.4])
def test_scale_slides_matches_jax(slides, tmp_path, target_mpp):
    from mipheivit_tpu_torch.scripts import scale_slides

    paths, _ = slides
    jax_script("scripts/scale_slides.py").scale_slide(
        paths["mif"], str(tmp_path / "jax.ome.tiff"), target_mpp, band_rows=96, n_levels=3)
    scale_slides.main(["--input", paths["mif"], "--out_dir", str(tmp_path / "port"),
                       "--target_mpp", str(target_mpp), "--band_rows", "96",
                       "--n_levels", "3"])
    assert_same_pyramid(tmp_path / "port" / "mif.tiff", tmp_path / "jax.ome.tiff")


# ---- row 2: registration ------------------------------------------------------

def test_registration_recovers_the_shift_as_jax_does(tmp_path):
    from mipheivit_tpu_torch.preprocessings.registration import registration

    rng = np.random.default_rng(3)
    h = w = 256
    pattern = rng.integers(0, 255, (h + 64, w + 64), dtype=np.uint8)
    fixed = np.stack([pattern[:h, :w]] * 3)
    moving = np.stack([pattern[12:12 + h, 16:16 + w].astype(np.uint16) * 100], 0)
    nuclei = np.zeros((1, h, w), np.int32)
    nuclei[0, 50:70, 50:70] = 5
    src = {}
    for name, arr in (("fixed", fixed), ("moving", moving), ("nuc", nuclei)):
        src[name] = str(tmp_path / f"{name}.tiff")
        write_pyramid(src[name], arr, n_levels=2, tile_size=64, mpp=0.5)
    want = jax_script("preprocessings/registration/registration.py").run_rigid(
        src["fixed"], src["moving"], str(tmp_path / "jax.ome.tiff"), src["nuc"],
        str(tmp_path / "jax_nuc.ome.tiff"), band_rows=48)
    registration.main(["--fixed_slide", src["fixed"], "--moving_slide", src["moving"],
                       "--out_path", str(tmp_path / "port.ome.tiff"), "--backend", "rigid",
                       "--nuclei_slide", src["nuc"], "--band_rows", "48"])
    got = registration.run_rigid(src["fixed"], src["moving"], str(tmp_path / "again.ome.tiff"),
                                 band_rows=48)
    assert got == want
    assert abs(got[0] + 16) < 2 and abs(got[1] + 12) < 2
    assert_same_pyramid(tmp_path / "port.ome.tiff", tmp_path / "jax.ome.tiff")
    assert_same_pyramid(tmp_path / "port_nuclei.ome.tiff", tmp_path / "jax_nuc.ome.tiff")
    lab = pyramid(tmp_path / "port_nuclei.ome.tiff")[1][0]
    assert (lab == 5).sum() == 400


# ---- row 3: tune_af_settings --------------------------------------------------

def test_tune_af_settings_matches_jax(slides, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.preprocessings.mif_cleaning import tune_af_settings

    paths, _ = slides
    args = ["--slide_path", paths["mif"], "--n_tiles", "6", "--tile_size", "96",
            "--lambdas", "0,0.1,0.2,0.3,0.5"]
    run_jax_main("preprocessings/mif_cleaning/tune_af_settings.py",
                 args + ["--out_json", tmp_path / "jax.json"], monkeypatch)
    tune_af_settings.main(args + ["--out_json", str(tmp_path / "port.json")])
    assert_same_text(tmp_path / "port.json", tmp_path / "jax.json")
    settings = json.loads((tmp_path / "port.json").read_text())
    assert sorted(settings, key=int) == [str(c) for c in range(1, N_CH)]


# ---- row 4: mif_cleaning ------------------------------------------------------

HIST_CASES = {
    "all tiles": {},
    "sampled tiles": {"max_tiles": 10, "seed": 7},
    "artifact channel": {"artifact_channel": 16, "artifact_threshold": 2000.0},
}


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_mif_cleaning_histograms_equal_jax(slides, case):
    from mipheivit_tpu_torch.preprocessings.mif_cleaning import mif_cleaning as port
    from mipheivit_tpu_torch.slideio import SlideReader

    jax = jax_script("preprocessings/mif_cleaning/mif_cleaning.py")
    paths, _ = slides
    kw = dict(tile_size=64, mask_thresh=0.05, **HIST_CASES[case])
    reader = SlideReader(paths["mif"], mode="IF")
    want, want_edges = jax.extract_histograms(reader, SETTINGS, 0, **kw)
    got, edges = port.extract_histograms(reader, SETTINGS, 0, device="cpu", **kw)
    reader.close()
    np.testing.assert_array_equal(edges, want_edges)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert want[5, -1] > 0 or case == "sampled tiles"      # 65535 lands in the last bin
    p99 = [port.find_percentile_bin(got[c], edges) for c in range(N_CH)]
    assert p99 == [jax.find_percentile_bin(want[c], want_edges) for c in range(N_CH)]


def test_mif_cleaning_cli_matches_jax(slides, tmp_path, monkeypatch, capsys):
    from mipheivit_tpu_torch.preprocessings.mif_cleaning import mif_cleaning

    jax = jax_script("preprocessings/mif_cleaning/mif_cleaning.py")
    paths, _ = slides
    (tmp_path / "settings.json").write_text(json.dumps(SETTINGS))
    args = ["--slide_path", paths["mif"], "--lambda_settings", tmp_path / "settings.json",
            "--channel_names", ",".join(NAMES), "--tile_size", "64", "--band_rows", "100",
            "--artifact_channel_name", "ART"]
    run_jax_main("preprocessings/mif_cleaning/mif_cleaning.py",
                 args + ["--out_path", tmp_path / "jax.ome.tiff"], monkeypatch)
    jax_p99 = capsys.readouterr().out.split("cleaned WSI")[0]
    out = mif_cleaning.main([str(a) for a in args]
                            + ["--out_path", str(tmp_path / "port.ome.tiff"), "--device", "cpu"])
    assert capsys.readouterr().out.split("cleaned WSI")[0] == jax_p99    # the printed p99s
    assert out["p99"].tolist() == [
        jax.find_percentile_bin(out["hists"][c], np.linspace(0, 65535, 4097))
        for c in range(N_CH)]
    (gm, gl), (wm, wl) = pyramid(tmp_path / "port.ome.tiff"), pyramid(tmp_path / "jax.ome.tiff")
    assert gm == wm and gm[2] == np.uint8
    off = 0
    for a, b in zip(gl, wl):
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= CLEAN_STEPS
        off += int((diff > 0).sum())
    share = off / sum(a.size for a in gl)
    print(f"mif_cleaning CPU vs JAX: {off} values off by one step, share {share:.2e}")
    assert share <= CLEAN_OFF_SHARE
    assert set(out["split"]) == {"read", "upload", "device", "write"} and out["mpx_per_s"] > 0


@pytest.mark.parametrize("script", ["mif_cleaning", "expression"])
def test_card_scripts_raise_without_a_card_unless_asked_for_the_cpu(slides, tmp_path, script):
    from mipheivit_tpu_torch.preprocessings.mif_cleaning import mif_cleaning
    from mipheivit_tpu_torch.preprocessings.single_cell_analysis import (
        extract_expression_matrix)

    if torch.cuda.is_available():
        pytest.skip("a card is here: the default device is the card")
    paths, root = slides
    if script == "mif_cleaning":
        (tmp_path / "s.json").write_text("{}")
        argv = ["--slide_path", paths["mif"], "--out_path", str(tmp_path / "o.tiff"),
                "--lambda_settings", str(tmp_path / "s.json"), "--channel_names",
                ",".join(NAMES)]
        main = mif_cleaning.main
    else:
        Table({"in_slide_name": ["s0"], "targ_slide_path": [paths["mif"]],
               "nuclei_slide_path": [paths["nuclei"]]}).to_csv(tmp_path / "slides.csv")
        argv = ["--slide_dataframe", str(tmp_path / "slides.csv"), "--out_dir", str(tmp_path)]
        main = extract_expression_matrix.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not (tmp_path / "o.tiff").exists() and not (tmp_path / "s0_cells.csv").exists()


# ---- row 5: tiling ------------------------------------------------------------

def test_tiling_matches_jax(slides, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.preprocessings import tiling

    paths, _ = slides
    Table({"in_slide_name": ["s0", "s1"], "in_slide_path": [paths["he"], paths["mif"]]}).to_csv(
        tmp_path / "slides.csv")
    args = ["--slide_dataframe", tmp_path / "slides.csv", "--tile_size", "64", "--overlap", "8"]
    run_jax_main("preprocessings/tiling.py", args + ["--out_csv", tmp_path / "jax.csv"],
                 monkeypatch)
    tiling.main([str(a) for a in args] + ["--out_csv", str(tmp_path / "port.csv")])
    assert_same_text(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert len(Table.read_csv(tmp_path / "port.csv")) > 20


# ---- rows 6-9, 11, 13, 14: the tile pipeline -----------------------------------

@pytest.fixture(scope="module")
def exported(slides):
    """Both packages' tile exports of the seeded slides (row 6), for the
    scripts that read tiles."""
    import pandas as pd

    from mipheivit_tpu_torch.preprocessings import wsi2tiles

    paths, root = slides
    slide_row = {"in_slide_name": "s0", "in_slide_path": paths["he"],
                 "targ_slide_path": paths["mif"], "nuclei_slide_path": paths["nuclei"]}
    tiles = {"in_slide_name": ["s0"] * 6, "x": [128, 192, 256, 128, 192, 256],
             "y": [128, 128, 128, 256, 256, 256], "level": [0] * 6,
             "tile_size_x": [64] * 6, "tile_size_y": [64] * 6}
    jax_out = jax_script("preprocessings/wsi2tiles.py").export_tiles(
        slide_row, pd.DataFrame(tiles), root / "jax_tiles", num_workers=2)
    jax_out.to_csv(root / "jax_tiles.csv", index=False)
    port_out = wsi2tiles.export_tiles(slide_row, Table(tiles), root / "port_tiles",
                                      num_workers=2)
    port_out.to_csv(root / "port_tiles.csv")
    return root


def test_wsi2tiles_matches_jax(exported):
    import cv2

    root = exported
    assert_same_text(root / "port_tiles.csv", root / "jax_tiles.csv",
                     [("port_tiles", "jax_tiles")])
    rows = Table.read_csv(root / "port_tiles.csv")
    assert len(rows) == 6
    for i in range(len(rows)):
        row = rows.row(i)
        other = {k: v.replace("port_tiles", "jax_tiles") for k, v in row.items()
                 if k.endswith("_path")}
        assert (Path(row["image_path"]).read_bytes()
                == Path(other["image_path"]).read_bytes())
        assert cv2.imread(row["image_path"]).std() > 0
        assert_same_pyramid(row["target_path"], other["target_path"])
        assert_same_pyramid(row["nuclei_path"], other["nuclei_path"])


def test_wsi2tiles_cli_rescaled_matches_jax(slides, tmp_path, monkeypatch):
    """At a fractional scale, on a 4-channel mIF slide (the JAX script's
    cv2 call refuses more); the port's export of the 17-channel slide holds
    the same first 4 channels."""
    from mipheivit_tpu_torch.preprocessings import wsi2tiles

    paths, _ = slides
    mif4 = str(tmp_path / "mif4.tiff")
    write_pyramid(mif4, np.moveaxis(pyramid(paths["mif"])[1][0][..., :4], -1, 0), n_levels=2,
                  tile_size=128, mpp=MPP)
    Table({"in_slide_name": ["s0", "s0"], "x": [100, 300], "y": [200, 200], "level": [0, 0],
           "tile_size_x": [96, 96], "tile_size_y": [96, 96]}).to_csv(tmp_path / "tiles.csv")
    for who, mif in (("jax", mif4), ("port", mif4), ("port17", paths["mif"])):
        Table({"in_slide_name": ["s0"], "in_slide_path": [paths["he"]],
               "targ_slide_path": [mif], "nuclei_slide_path": [paths["nuclei"]]}).to_csv(
            tmp_path / f"slides_{who}.csv")
        args = ["--slide_dataframe", tmp_path / f"slides_{who}.csv", "--tile_dataframe",
                tmp_path / "tiles.csv", "--out_dir", tmp_path / who, "--out_csv",
                tmp_path / f"{who}.csv", "--he_format", "jpg", "--rescale_mpp", "0.75"]
        if who == "jax":
            run_jax_main("preprocessings/wsi2tiles.py", args, monkeypatch)
        else:
            wsi2tiles.main([str(a) for a in args])
    assert_same_text(tmp_path / "port.csv", tmp_path / "jax.csv", [("/port/", "/jax/")])
    for kind, suffix in (("he", "jpg"), ("mif", "tiff"), ("nuclei", "tiff")):
        files = sorted((tmp_path / "port" / kind).glob(f"*.{suffix}"))
        assert len(files) == 2
        for f in files:
            twin = tmp_path / "jax" / kind / f.name
            if suffix == "jpg":
                assert f.read_bytes() == twin.read_bytes()
            else:
                assert_same_pyramid(f, twin)
                assert pyramid(f)[0][1][0] == (64, 64)
        if kind == "mif":
            for f in files:
                wide = pyramid(tmp_path / "port17" / kind / f.name)[1][0]
                assert wide.shape == (64, 64, N_CH)
                np.testing.assert_array_equal(wide[..., :4], pyramid(f)[1][0])


@pytest.mark.parametrize("size", [(150, 150), (173, 311), (200, 100), (450, 450)])
def test_resize_takes_any_number_of_channels(size):
    """``slideio.resize`` is cv2's resize wherever cv2 takes the array, and
    at a fractional area downscale of more than 4 channels (which cv2
    refuses) each channel's own resize."""
    import cv2

    from mipheivit_tpu_torch.slideio import resize

    arr = np.random.default_rng(1).integers(0, 60000, (300, 300, N_CH)).astype(np.uint16)
    for interp in (cv2.INTER_AREA, cv2.INTER_LINEAR, cv2.INTER_NEAREST):
        got = resize(arr, size, interp)
        try:
            want = cv2.resize(arr, size, interpolation=interp)
        except cv2.error:
            assert interp == cv2.INTER_AREA and size in ((173, 311), (200, 100))
            want = np.stack([cv2.resize(arr[..., c], size, interpolation=interp)
                             for c in range(N_CH)], -1)
        np.testing.assert_array_equal(got, want)


def test_single_channel_slides_convert_and_scale(slides, tmp_path):
    """The port converts and rescales one-channel slides (the JAX scripts
    read them widened to RGB and refuse them)."""
    from mipheivit_tpu_torch.preprocessings.convert_to_ometiff import convert
    from mipheivit_tpu_torch.scripts.scale_slides import scale_slide

    paths, _ = slides
    convert(paths["nuclei"], str(tmp_path / "nuc.ome.tiff"), ["labels"], n_levels=2,
            band_rows=200)
    np.testing.assert_array_equal(pyramid(tmp_path / "nuc.ome.tiff")[1][0],
                                  pyramid(paths["nuclei"])[1][0])
    one = str(tmp_path / "one.tiff")
    write_pyramid(one, np.moveaxis(pyramid(paths["mif"])[1][0][..., 3:4], -1, 0),
                  n_levels=2, tile_size=128, mpp=MPP)
    scale_slide(one, str(tmp_path / "scaled.ome.tiff"), 0.75, band_rows=100, n_levels=2)
    (meta, levels) = pyramid(tmp_path / "scaled.ome.tiff")
    assert meta[1][0] == (341, 341) and meta[4] == 1 and levels[0].any()


def test_create_dataframe_matches_jax(exported, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.scripts import create_dataframe

    root = exported
    nuc = np.concatenate([pyramid(p)[1][0].reshape(-1)
                          for p in sorted((root / "port_tiles" / "nuclei").glob("*.tiff"))])
    labels = np.unique(nuc[nuc > 0])
    rng = np.random.default_rng(5)
    cells = {"label": np.r_[labels, [10 ** 8]], "x": np.arange(len(labels) + 1)}
    for i, m in enumerate(NAMES[:4]):
        cells[f"{m}_pos"] = rng.random(len(labels) + 1) < 0.3 + 0.1 * i
    Table(cells).to_csv(tmp_path / "cells.csv")
    Table({"in_slide_name": ["s0"], "nuclei_csv_path": [str(tmp_path / "cells.csv")]}).to_csv(
        tmp_path / "slides.csv")
    names = ",".join(NAMES[:6])
    for who in ("jax", "port"):
        args = ["--tile_dataframe", root / f"{who}_tiles.csv", "--slide_dataframe",
                tmp_path / "slides.csv", "--channel_names", names, "--out_csv",
                tmp_path / f"{who}.csv"]
        if who == "jax":
            run_jax_main("scripts/create_dataframe.py", args, monkeypatch)
        else:
            create_dataframe.main([str(a) for a in args])
    assert_same_text(tmp_path / "port.csv", tmp_path / "jax.csv", [("port_tiles", "jax_tiles")])
    out = Table.read_csv(tmp_path / "port.csv")
    assert out["AF_count"].sum() > 0 and out["m5_count"].sum() == 0
    assert (out["m2_prop"] > 0).all()


def test_channel_stats_match_jax(exported, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.preprocessings import get_mean_std_channels

    root = exported
    for who in ("jax", "port"):
        for max_tiles in (0, 4):
            args = ["--tile_dataframe", root / f"{who}_tiles.csv", "--channel_names",
                    ",".join(NAMES), "--out_json", tmp_path / f"{who}{max_tiles}.json",
                    "--max_tiles", max_tiles]
            if who == "jax":
                run_jax_main("preprocessings/get_mean_std_channels.py", args, monkeypatch)
            else:
                get_mean_std_channels.main([str(a) for a in args])
    for max_tiles in (0, 4):
        assert_same_text(tmp_path / f"port{max_tiles}.json", tmp_path / f"jax{max_tiles}.json")
    stats = json.loads((tmp_path / "port0.json").read_text())
    assert stats["m3"]["std"] > 0 and stats["ART"]["idx_channel"] == N_CH - 1


def test_extract_std_matches_jax(exported, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.scripts import extract_std

    root = exported
    run_jax_main("scripts/extract_std.py", ["--train_dataframe", root / "jax_tiles.csv",
                                            "--out", tmp_path / "jax.json"], monkeypatch)
    extract_std.main(["--train_dataframe", str(root / "port_tiles.csv"),
                      "--out", str(tmp_path / "port.json")])
    assert_same_text(tmp_path / "port.json", tmp_path / "jax.json")
    assert len(json.loads((tmp_path / "port.json").read_text())["mean"]) == N_CH


def test_artifact_props_match_jax(exported, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.preprocessings.artifacts_detection import (
        extract_if_artifact_props)

    root = exported
    for who in ("jax", "port"):
        args = ["--tile_dataframe", root / f"{who}_tiles.csv", "--artifact_channels", "0,16",
                "--thresh", "1500", "--out_csv", tmp_path / f"{who}.csv"]
        if who == "jax":
            run_jax_main("preprocessings/artifacts_detection/extract_if_artifact_props.py",
                         args, monkeypatch)
        else:
            extract_if_artifact_props.main([str(a) for a in args])
    assert_same_text(tmp_path / "port.csv", tmp_path / "jax.csv", [("port_tiles", "jax_tiles")])
    assert Table.read_csv(tmp_path / "port.csv")["artifact_prop_ch16"].max() > 0


def test_orion_to_hemit_layout_matches_jax(exported, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.hemit import orion_to_hemit_layout

    root = exported
    for who in ("jax", "port"):
        csv = str(root / f"{who}_tiles.csv")
        args = ["--train_dataframe", csv, "--val_dataframe", csv, "--test_dataframe", csv,
                "--out_root", tmp_path / who]
        if who == "jax":
            run_jax_main("hemit/orion_to_hemit_layout.py", args, monkeypatch)
        else:
            orion_to_hemit_layout.main([str(a) for a in args])
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 36
    for rel in files:
        if rel.suffix == ".tiff":                 # the mIF re-encoded under the PNG's stem
            assert_same_pyramid(tmp_path / "port" / rel, tmp_path / "jax" / rel)
        else:
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_visualize_dataset_matches_jax(exported, tmp_path, monkeypatch):
    import cv2

    from mipheivit_tpu_torch.examples import visualize_dataset

    root = exported
    for who in ("jax", "port"):
        args = ["--tile_dataframe", root / f"{who}_tiles.csv", "--out_png",
                tmp_path / f"{who}.png", "--n_tiles", "3", "--seed", "4"]
        if who == "jax":
            run_jax_main("examples/visualize_dataset.py", args, monkeypatch)
        else:
            visualize_dataset.main([str(a) for a in args])
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    assert got.shape == (3 * 64, (1 + N_CH) * 64, 3)
    np.testing.assert_array_equal(got, want)


# ---- row 10: the expression matrix ---------------------------------------------

@pytest.mark.parametrize("tile_size", [8192, 200])
def test_expression_matrix_matches_jax(slides, tmp_path, tile_size):
    from mipheivit_tpu_torch.preprocessings.single_cell_analysis import (
        extract_expression_matrix as port)

    paths, _ = slides
    jax = jax_script("preprocessings/single_cell_analysis/extract_expression_matrix.py")
    jax.extract_expression_matrix(paths["mif"], paths["nuclei"], tile_size).to_csv(
        tmp_path / "jax.csv", index=False)
    port.extract_expression_matrix(paths["mif"], paths["nuclei"], tile_size,
                                   device="cpu").to_csv(tmp_path / "port.csv")
    assert_same_text(tmp_path / "port.csv", tmp_path / "jax.csv")
    got = Table.read_csv(tmp_path / "port.csv")
    nuc = pyramid(paths["nuclei"])[1][0]
    assert len(got) == len(np.unique(nuc[nuc > 0])) > 300
    assert got["area"].sum() == (nuc > 0).sum()


def test_expression_matrix_cli_matches_jax(slides, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.preprocessings.single_cell_analysis import (
        extract_expression_matrix)

    paths, _ = slides
    Table({"in_slide_name": ["s0"], "targ_slide_path": [paths["mif"]],
           "nuclei_slide_path": [paths["nuclei"]]}).to_csv(tmp_path / "slides.csv")
    run_jax_main("preprocessings/single_cell_analysis/extract_expression_matrix.py",
                 ["--slide_dataframe", tmp_path / "slides.csv", "--out_dir", tmp_path / "jax",
                  "--tile_size", 300], monkeypatch)
    stats = extract_expression_matrix.main([
        "--slide_dataframe", str(tmp_path / "slides.csv"), "--out_dir", str(tmp_path / "port"),
        "--tile_size", "300", "--device", "cpu"])
    assert_same_text(tmp_path / "port" / "s0_cells.csv", tmp_path / "jax" / "s0_cells.csv")
    assert stats[0]["cells"] > 300 and stats[0]["nuclei_per_s"] > 0


def test_expression_matrix_of_a_slide_without_nuclei_matches_jax(slides, tmp_path):
    from mipheivit_tpu_torch.preprocessings.single_cell_analysis import (
        extract_expression_matrix as port)

    paths, _ = slides
    empty = str(tmp_path / "empty.tiff")
    write_pyramid(empty, np.zeros((1, SIDE, SIDE), np.int32), n_levels=1, tile_size=128)
    jax = jax_script("preprocessings/single_cell_analysis/extract_expression_matrix.py")
    jax.extract_expression_matrix(paths["mif"], empty, 256).to_csv(tmp_path / "jax.csv",
                                                                    index=False)
    port.extract_expression_matrix(paths["mif"], empty, 256, device="cpu").to_csv(
        tmp_path / "port.csv")
    assert_same_text(tmp_path / "port.csv", tmp_path / "jax.csv")


# ---- row 12: convert_to_ometiff ------------------------------------------------

def test_convert_to_ometiff_matches_jax(slides, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.preprocessings import convert_to_ometiff

    paths, _ = slides
    for who in ("jax", "port"):
        args = ["--input", paths["mif"], "--output", tmp_path / f"{who}.ome.tiff",
                "--channel_names", ",".join(NAMES), "--n_levels", "3", "--tile_size", "256",
                "--band_rows", "200", "--mpp", "0.25"]
        if who == "jax":
            run_jax_main("preprocessings/convert_to_ometiff.py", args, monkeypatch)
        else:
            convert_to_ometiff.main([str(a) for a in args])
    assert_same_pyramid(tmp_path / "port.ome.tiff", tmp_path / "jax.ome.tiff")


# ---- row 15: ckpt_remove_foundation_model --------------------------------------

@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_ckpt_remove_foundation_model_matches_jax(tmp_path, monkeypatch, fmt):
    from mipheivit_tpu_torch.io.safetensors import load_file, save_file
    from mipheivit_tpu_torch.scripts import ckpt_remove_foundation_model

    g = torch.Generator().manual_seed(0)
    state = {
        "encoder.vit.blocks.0.attn.qkv.qkv.weight": torch.randn(12, 4, generator=g),
        "encoder.vit.blocks.0.attn.qkv.lora_q.A": torch.randn(4, 2, generator=g),
        "encoder.vit.blocks.0.attn.qkv.lora_v.B": torch.randn(2, 4, generator=g),
        "encoder.vit.pos_embed": torch.randn(1, 5, 4, generator=g),
        "encoder.neck.weight": torch.randn(3, 3, generator=g),
        "decoder.convstream.convs.0.conv.weight": torch.randn(8, 3, 3, 3, generator=g),
        "decoder.heads.0.bias": torch.arange(4, dtype=torch.int64),
        "decoder.convstream.convs.0.bn.num_batches_tracked": torch.tensor(7),     # 0-d
    }
    src = tmp_path / f"gen.{fmt}"
    if fmt == "pth":
        torch.save({"state_dict": state}, src)
    else:
        save_file(state, src)
    run_jax_main("scripts/ckpt_remove_foundation_model.py",
                 ["--checkpoint", src, "--out", tmp_path / "jax.safetensors"], monkeypatch)
    ckpt_remove_foundation_model.main(["--checkpoint", str(src), "--out",
                                       str(tmp_path / "port.safetensors")])
    got, want = load_file(tmp_path / "port.safetensors"), load_file(tmp_path / "jax.safetensors")
    assert sorted(got) == sorted(want) == sorted(
        k for k in state if not k.startswith("encoder.vit.") or ".lora" in k)
    for k in got:
        # the JAX script's writer (``np.ascontiguousarray``) widens a 0-d
        # tensor to shape [1]; the port keeps the source's shape
        assert got[k].dtype == want[k].dtype and got[k].shape == state[k].shape
        assert want[k].shape == (state[k].shape or (1,))
        torch.testing.assert_close(got[k], want[k].reshape(state[k].shape), rtol=0, atol=0)


# ---- the card against the CPU (gpu) ---------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_mif_cleaning_on_card_matches_cpu(slides, tmp_path):
    from mipheivit_tpu_torch.preprocessings.mif_cleaning import mif_cleaning

    _needs_card()
    paths, _ = slides
    (tmp_path / "settings.json").write_text(json.dumps(SETTINGS))
    args = ["--slide_path", paths["mif"], "--lambda_settings", str(tmp_path / "settings.json"),
            "--channel_names", ",".join(NAMES), "--tile_size", "64", "--band_rows", "100",
            "--artifact_channel_name", "ART"]
    card = mif_cleaning.main(args + ["--out_path", str(tmp_path / "card.ome.tiff")])
    cpu = mif_cleaning.main(args + ["--out_path", str(tmp_path / "cpu.ome.tiff"),
                                    "--device", "cpu"])
    np.testing.assert_array_equal(card["hists"], cpu["hists"])
    np.testing.assert_array_equal(card["p99"], cpu["p99"])
    (gm, gl), (wm, wl) = pyramid(tmp_path / "card.ome.tiff"), pyramid(tmp_path / "cpu.ome.tiff")
    assert gm == wm
    off = 0
    for a, b in zip(gl, wl):
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= CLEAN_STEPS
        off += int((diff > 0).sum())
    share = off / sum(a.size for a in gl)
    print(f"mif_cleaning card vs CPU: {off} values off by one step, share {share:.2e}")
    assert share <= CLEAN_OFF_SHARE


@pytest.mark.gpu
@pytest.mark.parametrize("tile_size", [8192, 200])
def test_expression_matrix_on_card_matches_cpu(slides, tmp_path, tile_size):
    from mipheivit_tpu_torch.preprocessings.single_cell_analysis import (
        extract_expression_matrix as port)

    _needs_card()
    paths, _ = slides
    port.extract_expression_matrix(paths["mif"], paths["nuclei"], tile_size).to_csv(
        tmp_path / "card.csv")
    port.extract_expression_matrix(paths["mif"], paths["nuclei"], tile_size,
                                   device="cpu").to_csv(tmp_path / "cpu.csv")
    assert_same_text(tmp_path / "card.csv", tmp_path / "cpu.csv")
    assert len(Table.read_csv(tmp_path / "card.csv")) > 300


def test_the_fifteen_modules_run_as_python_dash_m(tmp_path):
    """Each module answers ``--help`` through ``python -m`` with its
    original's flags (and ``--device`` on the two that run on the card)."""
    import subprocess

    mods = {
        "scripts.scale_slides": "scripts/scale_slides.py",
        "preprocessings.registration.registration":
            "preprocessings/registration/registration.py",
        "preprocessings.mif_cleaning.tune_af_settings":
            "preprocessings/mif_cleaning/tune_af_settings.py",
        "preprocessings.mif_cleaning.mif_cleaning": "preprocessings/mif_cleaning/mif_cleaning.py",
        "preprocessings.tiling": "preprocessings/tiling.py",
        "preprocessings.wsi2tiles": "preprocessings/wsi2tiles.py",
        "scripts.create_dataframe": "scripts/create_dataframe.py",
        "preprocessings.get_mean_std_channels": "preprocessings/get_mean_std_channels.py",
        "scripts.extract_std": "scripts/extract_std.py",
        "preprocessings.single_cell_analysis.extract_expression_matrix":
            "preprocessings/single_cell_analysis/extract_expression_matrix.py",
        "preprocessings.artifacts_detection.extract_if_artifact_props":
            "preprocessings/artifacts_detection/extract_if_artifact_props.py",
        "preprocessings.convert_to_ometiff": "preprocessings/convert_to_ometiff.py",
        "hemit.orion_to_hemit_layout": "hemit/orion_to_hemit_layout.py",
        "examples.visualize_dataset": "examples/visualize_dataset.py",
        "scripts.ckpt_remove_foundation_model": "scripts/ckpt_remove_foundation_model.py",
    }
    code = ("import runpy, sys\n"
            "for mod in sys.argv[1:]:\n"
            "    sys.argv = [mod, '--help']\n"
            "    try:\n"
            "        runpy.run_module('mipheivit_tpu_torch.' + mod, run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "    print('=====')\n")
    proc = subprocess.run([sys.executable, "-c", code, *mods], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    helps = proc.stdout.split("=====")[:-1]
    assert len(helps) == len(mods)
    import re

    for (mod, rel), text in zip(mods.items(), helps):
        want = set(re.findall(r'add_argument\(\s*"(--\w+)"', (REPO / rel).read_text()))
        got = set(re.findall(r"(--\w+)", text)) - {"--help"}
        extra = {"--device"} if "mif_cleaning.mif" in mod or "expression" in mod else set()
        assert got == want | extra, mod
