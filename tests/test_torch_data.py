"""The port's data layer against the JAX package's, on the CPU: the HED
colour space, the augmentations, the balanced sampler, the datasets, the
threaded ``Loader``, the CSV ``Table`` and ``device_prefetch``.

Same seeds, same files, same draws: everything is exact except the Gaussian
blur, which the port computes in numpy where the JAX package calls cv2; where
it fired, outputs agree within ``BLUR_ATOL`` on the 0-255 scale.
"""

import csv
import json

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.data.augment as port_augment
from mipheivit_tpu_torch.data.table import Table
from mipheivit_tpu_torch.slideio import write_pyramid

import torch_synthetic_run as syn

pd = pytest.importorskip("pandas")

BLUR_ATOL = 1e-3        # on the 0-255 scale, where the blur fired
HED_ATOL = 1e-6


@pytest.fixture
def blur_calls(monkeypatch):
    calls = []
    real = port_augment.gaussian_blur

    def counted(img, sigma, ksize=7):
        calls.append(sigma)
        return real(img, sigma, ksize)

    monkeypatch.setattr(port_augment, "gaussian_blur", counted)
    return calls


def test_hed_round_trip_matches_jax():
    from mipheivit_tpu.ops import hed as jax_hed
    from mipheivit_tpu_torch.ops import hed

    rgb = np.random.default_rng(0).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    for x in (rgb, rgb.astype(np.float64) / 255.0):
        h = hed.rgb2hed(x)
        np.testing.assert_allclose(h, jax_hed.rgb2hed(x), rtol=0, atol=HED_ATOL)
        np.testing.assert_allclose(hed.hed2rgb(h), jax_hed.hed2rgb(h), rtol=0, atol=HED_ATOL)


def test_gaussian_blur_matches_cv2():
    import cv2

    rng = np.random.default_rng(1)
    for sigma in (0.1, 0.5, 1.0, 1.5):
        for shape in ((32, 32, 3), (17, 40, 3), (256, 256, 3)):
            img = rng.uniform(-20.0, 280.0, shape).astype(np.float32)
            got = port_augment.gaussian_blur(img, sigma)
            assert got.dtype == np.float32 and got.shape == img.shape
            np.testing.assert_allclose(got, cv2.GaussianBlur(img, (7, 7), sigmaX=sigma),
                                       rtol=0, atol=BLUR_ATOL)


def _images(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(30, 230, (40, 36, 3), dtype=np.uint8),
            rng.integers(0, 255, (40, 36, 2), dtype=np.uint8))


def test_spatial_augment_matches_jax():
    from mipheivit_tpu.data import augment as jax_augment

    for training in (True, False):
        for seed in range(40):
            he, mif = _images(seed)
            arrays = {"image": he, "image_target": mif, "nuclei": mif[..., 0].astype(np.int32)}
            got = port_augment.SpatialAugment(32, 32, training)(arrays, np.random.default_rng(seed))
            want = jax_augment.SpatialAugment(32, 32, training)(arrays, np.random.default_rng(seed))
            for key in arrays:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{seed} {key}")


def test_color_augments_match_jax(blur_calls):
    """HED jitter alone (uint8 and float) exactly; the whole colour chain
    exactly where the blur did not fire, within ``BLUR_ATOL`` where it did."""
    from mipheivit_tpu.data import augment as jax_augment

    for seed in range(30):
        he, _ = _images(seed)
        for img in (he, he.astype(np.float32) / 255.0):
            np.testing.assert_array_equal(
                port_augment.HedColorAugment(p=1.0)(img, np.random.default_rng(seed)),
                jax_augment.HedColorAugment(p=1.0)(img, np.random.default_rng(seed)))
    blurred = 0
    for seed in range(200):
        he, _ = _images(seed)
        n = len(blur_calls)
        got = port_augment.ColorAugment()(he, np.random.default_rng(seed))
        want = jax_augment.ColorAugment()(he, np.random.default_rng(seed))
        if len(blur_calls) > n:
            blurred += 1
            np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_ATOL, err_msg=str(seed))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(seed))
    assert blurred > 5


def _sampler_frame(n=30):
    rng = np.random.default_rng(2)
    return {"CD31_count": rng.integers(0, 10, n), "CD3e_count": rng.integers(0, 10, n),
            "CD31_prop": rng.uniform(0, 1, n)}


def test_balanced_sampler_epochs_match_jax():
    from mipheivit_tpu.data.sampler import BalancedPositiveSampler as JaxSampler
    from mipheivit_tpu_torch.data.sampler import BalancedPositiveSampler

    cols = _sampler_frame()
    for thresh, other in ((4, 0.2), (7, 0.5), (1, 0.1)):
        got = BalancedPositiveSampler(Table(cols), ["CD31", "CD3e"], thresh, other, seed=3)
        want = JaxSampler(pd.DataFrame(cols), ["CD31", "CD3e"], thresh, other, seed=3)
        assert got.column_name == want.column_name and len(got) == len(want)
        for _ in range(3):
            idx = got.epoch_indices()
            np.testing.assert_array_equal(idx, want.epoch_indices())
            assert idx.dtype == np.int64


def test_table_matches_pandas_read_csv(tmp_path):
    rows = [["a", "b", "c", "d", "e", "f", "g"],
            ["1", "1.5", "x/y.tiff", "True", "", "-3", "1e-3"],
            ["22", "", "z", "False", "", "4", "inf"],
            ["-7", "2", "w", "True", "", "0", "2.5E+2"]]
    path = tmp_path / "t.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    paths = [path]
    values = syn.write_run(tmp_path / "run", n_tiles=6)
    paths += [values[f"data.{s}_dataframe_path"] for s in ("train", "val", "test")]
    for p in paths:
        got, want = Table.read_csv(p), pd.read_csv(p)
        assert got.columns == list(want.columns) and len(got) == len(want)
        for col in want.columns:
            if pd.api.types.is_string_dtype(want[col]):     # object, or pandas' str dtype
                assert got[col].dtype == object, (p, col)
                assert got[col].tolist() == want[col].tolist()
            else:
                assert got[col].dtype == want[col].dtype, (p, col, got[col].dtype)
                np.testing.assert_array_equal(got[col], want[col].to_numpy())
    t = Table.read_csv(path)
    assert t.take([2, 0])["a"].tolist() == [-7, 1]
    assert t.filter(t["a"] > 0)["c"].tolist() == ["x/y.tiff", "z"]
    assert t[["a", "g"]].columns == ["a", "g"] and t.row(1)["c"] == "z"
    assert t.unique("d") == [True, False]
    assert t.replace("c", ["p", "q", "r"])["c"].tolist() == ["p", "q", "r"]
    assert t.mapping("c", "a") == {"x/y.tiff": 1, "z": 22, "w": -7}


def test_npy_tiles_read_as_their_tiff_twins(tmp_path):
    """``read_image`` takes HWC and HW ``.npy`` tiles (no cv2, no libtiff):
    a dataset over them yields what it yields over the same tiles as TIFF."""
    from mipheivit_tpu_torch.data.dataset import TileImg2ImgDataset
    from mipheivit_tpu_torch.slideio import read_image

    values = syn.write_run(tmp_path / "run", n_tiles=6)
    tiff = Table.read_csv(values["data.train_dataframe_path"])
    paths = {}
    for col in ("image_path", "target_path"):
        paths[col] = [p.replace(".tiff", ".npy") for p in tiff[col]]
        for src, dst in zip(tiff[col], paths[col]):
            np.save(dst, read_image(src))
    np.save(tmp_path / "gray.npy", np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert read_image(tmp_path / "gray.npy").shape == (3, 4, 1)
    npy = tiff.replace("image_path", paths["image_path"]).replace("target_path",
                                                                   paths["target_path"])
    spatial, color = port_augment.get_augmentations(32, 32, True)
    datasets = [TileImg2ImgDataset(t, targ_channel_idxs=[1], spatial_augmentations=spatial,
                                   color_augmentations=color) for t in (npy, tiff)]
    for idx in range(len(tiff)):
        got, want = (ds.__getitem__(idx, rng=np.random.default_rng(idx)) for ds in datasets)
        _assert_items_equal(got, want, False)


def _slides(tmp_path, n_slides=2, side=96):
    """Two 2-level pyramids each of H&E, mIF and nuclei, a slide dataframe
    and tile rows at both levels."""
    rng = np.random.default_rng(4)
    slide_rows, tile_rows = [], []
    for s in range(n_slides):
        paths = {}
        for kind, chans in (("in", 3), ("targ", 2), ("nuclei", 1)):
            arr = rng.integers(0, 255, (chans, side, side), dtype=np.uint8)
            paths[kind] = str(tmp_path / f"s{s}_{kind}.tiff")
            write_pyramid(paths[kind], arr, n_levels=2, tile_size=32)
        slide_rows.append({"in_slide_name": f"s{s}", "in_slide_path": paths["in"],
                           "targ_slide_path": paths["targ"],
                           "nuclei_slide_path": paths["nuclei"]})
        for x, y, level in ((0, 0, 0), (40, 20, 0), (56, 60, 0), (8, 4, 1)):
            tile_rows.append({"in_slide_name": f"s{s}", "x": x, "y": y, "level": level,
                              "tile_size_x": 40, "tile_size_y": 36,
                              "CD31_count": x % 7, "CD3e_count": y % 5})
    for name, rows in (("slides", slide_rows), ("tiles", tile_rows)):
        with open(tmp_path / f"{name}.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    return tmp_path / "slides.csv", tmp_path / "tiles.csv"


def _assert_items_equal(got, want, blurred):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            if key == "image" and blurred:
                np.testing.assert_allclose(got[key], value, rtol=0, atol=BLUR_ATOL)
            else:
                np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def test_datasets_match_jax(tmp_path, blur_calls):
    """``TileImg2ImgDataset`` and ``SlideImg2ImgDataset`` items (with the
    training augmentations and the normalizers), ``SlideDataset`` and
    ``TileDataset`` items, equal to the JAX package's."""
    from mipheivit_tpu.data import dataset as jd
    from mipheivit_tpu.data.augment import get_augmentations as jax_augmentations
    from mipheivit_tpu.data.stats import Normalizer as JaxNormalizer
    from mipheivit_tpu_torch.data import dataset as pd_
    from mipheivit_tpu_torch.data.augment import get_augmentations
    from mipheivit_tpu_torch.data.stats import Normalizer

    values = syn.write_run(tmp_path / "run", n_tiles=6)
    slides, tiles = _slides(tmp_path)
    rgb = {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]}
    norms = [(Normalizer(rgb, "he"), Normalizer(mode="if")),
             (JaxNormalizer(rgb, "he"), JaxNormalizer(mode="if"))]
    cases = []
    for training in (True, False):
        ps, pc = get_augmentations(32, 32, training)
        js, jc = jax_augmentations(32, 32, training)
        kw_p = dict(preprocess_input_fn=norms[0][0], preprocess_target_fn=norms[0][1],
                    spatial_augmentations=ps, color_augmentations=pc)
        kw_j = dict(preprocess_input_fn=norms[1][0], preprocess_target_fn=norms[1][1],
                    spatial_augmentations=js, color_augmentations=jc)
        train_csv = values["data.train_dataframe_path"]
        cases.append((pd_.TileImg2ImgDataset(Table.read_csv(train_csv), targ_channel_idxs=[1, 0],
                                             **kw_p),
                      jd.TileImg2ImgDataset(pd.read_csv(train_csv), targ_channel_idxs=[1, 0],
                                            **kw_j)))
        for nuclei in (False, True):
            cases.append((
                pd_.SlideImg2ImgDataset(Table.read_csv(slides), Table.read_csv(tiles),
                                        return_nuclei=nuclei, **kw_p),
                jd.SlideImg2ImgDataset(pd.read_csv(slides), pd.read_csv(tiles),
                                       return_nuclei=nuclei, **kw_j)))
        cases.append((pd_.SlideDataset(Table.read_csv(slides), Table.read_csv(tiles),
                                       spatial_augmentations=ps),
                      jd.SlideDataset(pd.read_csv(slides), pd.read_csv(tiles),
                                      spatial_augmentations=js)))
        cases.append((pd_.TileDataset(Table.read_csv(train_csv), spatial_augmentations=ps),
                      jd.TileDataset(pd.read_csv(train_csv), spatial_augmentations=js)))
    for got_ds, want_ds in cases:
        assert len(got_ds) == len(want_ds)
        for idx in range(len(want_ds)):
            for seed in (idx, 100 + idx):
                n = len(blur_calls)
                got = got_ds.__getitem__(idx, rng=np.random.default_rng(seed))
                want = want_ds.__getitem__(idx, rng=np.random.default_rng(seed))
                _assert_items_equal(got, want, len(blur_calls) > n)
    got = pd_.SlideDataset.from_one_slide(str(tmp_path / "s0_in.tiff"), [(0, 0), (32, 64)], 32)
    want = jd.SlideDataset.from_one_slide(str(tmp_path / "s0_in.tiff"), [(0, 0), (32, 64)], 32)
    for idx in range(2):
        _assert_items_equal(got[idx], want[idx], False)


def test_loader_batches_match_jax_over_two_epochs(tmp_path, blur_calls):
    """``DataModule`` loaders, train (shuffled, drop_last; and through the
    balanced sampler) and val/test (``pad_to_batch`` with the mask), over two
    epochs: every batch equal to the JAX package's."""
    from mipheivit_tpu.data.dataset import DataModule as JaxDataModule
    from mipheivit_tpu.data.sampler import BalancedPositiveSampler as JaxSampler
    from mipheivit_tpu_torch.data.dataset import DataModule
    from mipheivit_tpu_torch.data.sampler import BalancedPositiveSampler

    values = syn.write_run(tmp_path / "run", n_tiles=14)
    frames = {s: values[f"data.{s}_dataframe_path"] for s in ("train", "val", "test")}
    for use_sampler in (False, True):
        tables = {s: Table.read_csv(p) for s, p in frames.items()}
        dfs = {s: pd.read_csv(p) for s, p in frames.items()}
        got_dm = DataModule(None, tables["train"], tables["val"], tables["test"], [0, 1], 3,
                            (32, 32), seed=5, train_sampler=BalancedPositiveSampler(
                                tables["train"], syn.MARKERS, 4) if use_sampler else None)
        want_dm = JaxDataModule(None, dfs["train"], dfs["val"], dfs["test"], [0, 1], 3,
                                (32, 32), seed=5, train_sampler=JaxSampler(
                                    dfs["train"], syn.MARKERS, 4) if use_sampler else None)
        got_dm.setup()
        want_dm.setup()
        for epoch in range(2):
            for split in ("train", "val", "test"):
                loaders = [dm.loader(split, epoch=epoch) for dm in (got_dm, want_dm)]
                for loader in loaders:
                    loader.pad_to_batch = split != "train"
                n = len(blur_calls)
                got, want = (list(loader) for loader in loaders)
                assert len(got) == len(want) > 0
                for g, w in zip(got, want):
                    if split != "train":
                        assert g["mask"].sum() <= 3 and g["image"].shape[0] == 3
                    _assert_items_equal(g, w, len(blur_calls) > n)
                assert loaders[0].stats.batches == len(got)


def test_device_prefetch_on_the_cpu_and_without_a_card(monkeypatch):
    from mipheivit_tpu_torch.data.pipeline import collate, device_prefetch

    rng = np.random.default_rng(6)
    batches = [collate([{"image": rng.standard_normal((4, 4, 3)).astype(np.float32),
                         "target": rng.standard_normal((4, 4, 2)).astype(np.float32),
                         "tile_name": f"t{b}{i}"} for i in range(2)]) for b in range(5)]
    for size in (1, 2, 7):
        got = list(device_prefetch(iter(batches), size=size, device="cpu"))
        assert len(got) == len(batches)
        for g, w in zip(got, batches):
            for key in ("image", "target"):
                assert isinstance(g[key], torch.Tensor) and g[key].device.type == "cpu"
                np.testing.assert_array_equal(g[key].numpy(), w[key])
            assert g["tile_name"] == w["tile_name"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter(batches)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_prefetch_on_the_card(cuda):
    """Pinned buffers copied on the side stream, ``size`` batches ahead,
    while the consumer's stream is busy with each batch: every tensor the
    consumer reads holds its batch's values."""
    from mipheivit_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.default_rng(8)
    batches = [{"image": rng.standard_normal((8, 64, 64, 3)).astype(np.float32),
                "mask": np.ones(8, np.float32), "tile_name": [f"t{b}"]} for b in range(12)]
    busy = torch.randn(2048, 2048, device=cuda)
    for size in (1, 2, 4):
        sums = []
        for got, want in zip(device_prefetch(iter(batches), size=size, device=cuda), batches):
            assert got["image"].device.type == "cuda" and got["tile_name"] == want["tile_name"]
            for _ in range(4):
                busy = torch.tanh(busy @ busy)      # keep the consumer's stream busy
            sums.append(got["image"].double().sum() + got["mask"].double().sum())
        want_sums = [float(b["image"].astype(np.float64).sum()) + 8.0 for b in batches]
        np.testing.assert_allclose(torch.stack(sums).cpu().numpy(), want_sums, rtol=1e-9)


def test_metrics_logger_and_png_grid(tmp_path):
    """``metrics.jsonl`` lines as the JAX logger writes them, and the debug
    grid as a PNG that cv2 decodes to the same pixels as the JAX package's
    cv2-written grid."""
    import cv2

    from mipheivit_tpu.utils import MetricsLogger as JaxLogger
    from mipheivit_tpu.utils import save_image_grid as jax_grid
    from mipheivit_tpu_torch.utils import MetricsLogger, save_image_grid

    for cls, sub in ((MetricsLogger, "port"), (JaxLogger, "jax")):
        logger = cls(str(tmp_path / sub), use_wandb=False)
        logger.log({"a": 1.5, "b": np.float32(2.0), "c": float("nan"), "d": "x",
                    "e": torch.tensor(3.0) if sub == "port" else 3.0}, step=7)
        logger.finish()
    lines = {sub: json.loads((tmp_path / sub / "metrics.jsonl").read_text())
             for sub in ("port", "jax")}
    assert {k: v for k, v in lines["port"].items() if k != "time"} == \
        {k: v for k, v in lines["jax"].items() if k != "time"}

    rng = np.random.default_rng(7)
    he = rng.uniform(-10, 270, (5, 16, 12, 3)).astype(np.float32)
    pred, target = (rng.uniform(-1, 1, (5, 16, 12, 2)).astype(np.float32) for _ in range(2))
    save_image_grid(str(tmp_path / "port.png"), he, pred, target)
    jax_grid(str(tmp_path / "jax.png"), he, pred, target)
    got, want = (cv2.imread(str(tmp_path / f"{s}.png")) for s in ("port", "jax"))
    assert got.shape == (4 * 16, 5 * 12, 3)
    np.testing.assert_array_equal(got, want)
