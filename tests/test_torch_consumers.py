"""The port's copies of the five scripts outside the JAX package that run a
model, each against its JAX original on the same synthetic tiles, slide,
dataframes and weights, with the encoder spec cut to a tiny ViT (patch 4,
width 128, 2 blocks, 2 heads of 64) in both packages:

- ``preprocessings/artifacts_detection/extract_embeddings.py``: equal names
  and shards; the class tokens within 2e-4 before the f16 cast (the
  encoder's tolerance), the f16 shards within one f16 step of that;
- ``figures/datasets_umap.py``: the same sampled tiles, their class tokens
  within 2e-4, the split labels equal, the PNG written;
- ``examples/roi_inference.py``: the predicted mIF within one uint8 step,
  the same nuclei (the segmenter stubbed to one fixed label map, fed each
  package's own nuclear channel) and the cell table's marker means within
  5e-4 (the generator's tolerance), its logreg gates equal away from 0.5;
- ``figures/prediction_panels.py``: the same tiles and targets, the
  predictions within one uint8 step, the PNGs written;
- ``scripts/inference_hemit.py``: the ``_real_A`` / ``_real_B`` PNGs equal
  and ``_fake_B`` within one step (a tiny ConvNeXt U-Net in both).
"""

import csv
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
for sub in ("scripts", "tests", "examples", "figures", "preprocessings/artifacts_detection"):
    sys.path.insert(0, str(REPO / sub))

torch.set_num_threads(2)

NAMES = ["CD31", "CD3e", "Ki67"]
TINY = dict(patch_size=4, embed_dim=128, depth=2, num_heads=2, mlp_hidden_dim=256,
            mlp_type="swiglu", init_values=1e-5, reg_tokens=4, no_embed_class=True)
IMG = 32                # the encoder's tiles (extract_embeddings, datasets_umap)
GEN_IMG = 128           # the flagship's (get_generator takes powers of 2 from 128)
ENC_TOL = 2e-4          # the encoder's f32 tolerance
GEN_TOL = 5e-4          # the generator's
STATS = {"RGB": {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]},
         **{m: {"idx_channel": i, "std": 10.0, "min": 0} for i, m in enumerate(NAMES)}}


@pytest.fixture(scope="module")
def tiny_specs():
    """Both packages' ``hoptimus0`` cut to TINY, for the module's tests."""
    import extract_embeddings as jax_extract

    import mipheivit_tpu.models as jax_models
    import mipheivit_tpu.models.foundation as jax_foundation
    from mipheivit_tpu.models.foundation import EncoderSpec
    from mipheivit_tpu.models.vit import ViTConfig as JaxViTConfig
    from mipheivit_tpu_torch.models import foundation

    real = jax_foundation.get_encoder_spec

    def spec(name, img_size):
        if name != "hoptimus0":
            return real(name, img_size)
        img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        return EncoderSpec(name, "vit", JaxViTConfig(img_size=img_size, **TINY), "tiny")

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_foundation, jax_models, jax_extract):
            mp.setattr(mod, "get_encoder_spec", spec)
        mp.setitem(foundation._VIT_SPECS, "hoptimus0", (TINY, "tiny"))
        yield


def _write_png(path, img):
    import cv2

    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def _tiles(root: Path, n: int, side: int, seed: int):
    """n uint8 H&E-like PNG tiles (smooth blobs plus noise) -> their paths."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:side, :side]
    paths = []
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = rng.integers(100, 200, (side, side, 3)).astype(np.float32)
        for _ in range(4):
            cy, cx, r = rng.uniform(4, side - 4, 2).tolist() + [rng.uniform(3, 6)]
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] -= 80
        p = root / f"tile_{i:02d}.png"
        _write_png(p, np.clip(img, 0, 255).astype(np.uint8))
        paths.append(str(p))
    return paths


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _encoder_file(path):
    """A timm-layout file of the tiny encoder's weights
    (``make_parity_fixtures.synth_state_dict``)."""
    from make_parity_fixtures import synth_state_dict

    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.models.vit import ViTConfig, VisionTransformer

    vit = VisionTransformer(ViTConfig(img_size=(IMG, IMG), **TINY))
    save_file(synth_state_dict([(k, tuple(v.shape)) for k, v in vit.state_dict().items()]),
              path)
    return str(path)


def _read_names(path):
    return Path(path).read_text().splitlines()


def test_extract_embeddings_matches_jax(tiny_specs, tmp_path, monkeypatch):
    import extract_embeddings as jax_extract
    import jax.numpy as jnp

    from mipheivit_tpu.models.import_weights import load_state_dict, vit_params_from_torch
    from mipheivit_tpu.models.vit import VisionTransformer as JaxVisionTransformer
    from mipheivit_tpu_torch.infer.loading import load_state_dict as port_load
    from mipheivit_tpu_torch.infer.loading import load_vit_encoder
    from mipheivit_tpu_torch.models.foundation import get_encoder_spec
    from mipheivit_tpu_torch.preprocessings.artifacts_detection import extract_embeddings

    paths = _tiles(tmp_path / "tiles", 7, 40, seed=1)     # center-cropped to 32
    _write_csv(tmp_path / "tiles.csv", [{"image_path": p} for p in paths])
    enc = _encoder_file(tmp_path / "enc.safetensors")
    args = ["--tile_dataframe", str(tmp_path / "tiles.csv"), "--encoder_weights", enc,
            "--img_size", str(IMG), "--batch_size", "3", "--shard_size", "4"]
    monkeypatch.setattr(sys, "argv", ["extract_embeddings.py", *args,
                                      "--out_dir", str(tmp_path / "jax")])
    jax_extract.main()
    extract_embeddings.main([*args, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])

    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jax_files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert jax_files == ["embeddings_0000.npy", "embeddings_0001.npy",
                         "names_0000.csv", "names_0001.csv"]
    for name in jax_files:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".csv"):
            assert _read_names(a) == _read_names(b)
            continue
        want, got = np.load(a), np.load(b)
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        step = np.spacing(np.abs(want)).astype(np.float32)
        assert (np.abs(got.astype(np.float32) - want.astype(np.float32))
                <= ENC_TOL + step).all()
    # before the cast: the two encoders on one normalized batch
    from mipheivit_tpu.data.stats import HOPTIMUS_MEAN, HOPTIMUS_STD

    x = np.stack([(np.asarray(__import__("cv2").imread(p)[..., ::-1], np.float32)[4:36, 4:36]
                   - HOPTIMUS_MEAN) / HOPTIMUS_STD for p in paths[:3]]).astype(np.float32)
    cfg = jax_extract.get_encoder_spec("hoptimus0", IMG).vit_cfg
    want = np.asarray(JaxVisionTransformer(cfg).apply(
        {"params": vit_params_from_torch(load_state_dict(enc), cfg)}, jnp.asarray(x))[:, 0])
    port = load_vit_encoder(get_encoder_spec("hoptimus0", IMG).vit_cfg, port_load(enc), "cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=ENC_TOL, rtol=0)


def test_datasets_umap_matches_jax(tiny_specs, tmp_path, monkeypatch):
    import datasets_umap as jax_umap

    from mipheivit_tpu_torch.figures import datasets_umap

    csvs = {}
    for i, split in enumerate(("train", "val", "test")):
        paths = _tiles(tmp_path / split, 5, IMG, seed=10 + i)
        csvs[split] = str(tmp_path / f"{split}.csv")
        _write_csv(csvs[split], [{"image_path": p} for p in paths])
    enc = _encoder_file(tmp_path / "enc.safetensors")
    seen = {}

    def recording(tag, mod):
        real = mod.reduce_2d

        def reduce(embs, seed=0):
            seen[tag] = np.asarray(embs)
            return real(embs, seed)

        monkeypatch.setattr(mod, "reduce_2d", reduce)

    recording("jax", jax_umap)
    recording("port", datasets_umap)
    args = ["--train_csv", csvs["train"], "--val_csv", csvs["val"], "--test_csv", csvs["test"],
            "--encoder_ckpt", enc, "--n_per_split", "4", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["datasets_umap.py", *args,
                                      "--out_path", str(tmp_path / "jax.png")])
    jax_umap.main()
    datasets_umap.main([*args, "--out_path", str(tmp_path / "port.png"), "--device", "cpu"])
    assert (tmp_path / "jax.png").exists() and (tmp_path / "port.png").exists()
    assert seen["port"].shape == seen["jax"].shape == (12, 128)
    np.testing.assert_allclose(seen["port"], seen["jax"], atol=ENC_TOL, rtol=0)
    # the same rows sampled: each split's tiles in the order pandas draws them
    import pandas as pd

    from mipheivit_tpu_torch.data.table import Table

    for split in ("train", "val", "test"):
        want = pd.read_csv(csvs[split]).sample(4, random_state=3)["image_path"].tolist()
        assert list(Table.read_csv(csvs[split]).sample(4, random_state=3)["image_path"]) == want


@pytest.fixture(scope="module")
def flagship(tiny_specs, tmp_path_factory):
    """A checkpoint dir of the tiny flagship (LoRA rank 8, encoder included,
    ``synth_state_dict`` weights), its config (the miphei-vit preset), a
    channel_stats file, a ``logreg.npz`` and a test dataframe of 3 tiles
    with 3-marker TIFF targets."""
    from make_parity_fixtures import synth_state_dict

    from mipheivit_tpu.config import compose, save_config
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.models import get_generator
    from mipheivit_tpu_torch.slideio import write_pyramid

    root = tmp_path_factory.mktemp("flagship")
    ckpt = root / "ckpt"
    ckpt.mkdir()
    shapes = [(k, tuple(v.shape)) for k, v in get_generator(
        "myvitmatte", GEN_IMG, len(NAMES), "hoptimus0", device="meta").state_dict().items()]
    save_file(synth_state_dict(shapes), ckpt / "model.safetensors")
    rng = np.random.default_rng(4)
    np.savez(ckpt / "logreg.npz", weight=rng.standard_normal((3, 3)).astype(np.float32) * 4,
             bias=rng.standard_normal(3).astype(np.float32))
    (root / "channel_stats.json").write_text(json.dumps(STATS))
    rows = []
    for i, p in enumerate(_tiles(root / "tiles", 3, GEN_IMG, seed=20)):
        target = root / "tiles" / f"target_{i}.tiff"
        write_pyramid(str(target), rng.integers(0, 255, (3, GEN_IMG, GEN_IMG), dtype=np.uint8),
                      n_levels=1, tile_size=GEN_IMG)
        rows.append({"image_path": p, "target_path": str(target)})
    _write_csv(root / "test.csv", rows)
    cfg = compose(["+default_configs=miphei-vit"])
    cfg.data.test_dataframe_path = str(root / "test.csv")
    cfg.data.channel_stats_path = str(root / "channel_stats.json")
    cfg.data.targ_channel_names = NAMES
    save_config(cfg, ckpt / "config.yaml")
    return ckpt, rows


def _blob_labels():
    """The stub segmenter's label map: 5 nuclei of 36 to 144 pixels."""
    labels = np.zeros((GEN_IMG, GEN_IMG), np.int32)
    for i, (y, x, r) in enumerate(((4, 4, 6), (4, 60, 12), (66, 10, 9), (90, 92, 7),
                                   (110, 30, 10)), 1):
        labels[y:y + r, x:x + r] = i
    return labels


def _read_table(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: [r[k] for r in rows] for k in rows[0]}


def test_roi_inference_matches_jax(flagship, tmp_path, monkeypatch):
    import roi_inference as jax_roi  # puts the JAX nuclei_segmentation dir on sys.path

    import backends as jax_backends

    from mipheivit_tpu.slideio import TiffSlide
    from mipheivit_tpu_torch.examples import roi_inference

    ckpt, rows = flagship
    fed = {}

    def stub(tag):
        def segment(dapi):
            fed[tag] = np.array(dapi)
            return _blob_labels()
        return lambda name="auto", **kw: segment

    monkeypatch.setattr(jax_backends, "get_backend", stub("jax"))
    monkeypatch.setattr(roi_inference, "get_backend", stub("port"))
    args = ["--checkpoint_dir", str(ckpt), "--input", rows[0]["image_path"],
            "--size", str(GEN_IMG)]
    monkeypatch.setattr(sys, "argv", ["roi_inference.py", *args,
                                      "--out_prefix", str(tmp_path / "jax")])
    jax_roi.main()
    roi_inference.main([*args, "--out_prefix", str(tmp_path / "port"), "--device", "cpu"])

    mifs = {}
    for tag in ("jax", "port"):
        ts = TiffSlide(str(tmp_path / f"{tag}_mif.ome.tiff"))
        mifs[tag] = ts.read_region((0, 0), 0, (GEN_IMG, GEN_IMG)).astype(np.int32)
        ts.close()
    assert np.abs(mifs["port"] - mifs["jax"]).max() <= 1
    assert np.abs(fed["port"].astype(np.int32) - fed["jax"].astype(np.int32)).max() <= 1
    want, got = (_read_table(tmp_path / f"{tag}_cells.csv") for tag in ("jax", "port"))
    assert list(got) == list(want)
    assert got["cell_id"] == want["cell_id"] == [str(i) for i in range(1, 6)]
    assert got["area"] == want["area"]
    for m in NAMES:
        np.testing.assert_allclose(np.float64(got[f"{m}_pred"]), np.float64(want[f"{m}_pred"]),
                                   atol=GEN_TOL, rtol=0)
    data = np.load(ckpt / "logreg.npz")
    means = np.stack([np.float64(want[f"{m}_pred"]) for m in NAMES], 1)
    p = 1 / (1 + np.exp(-(means @ data["weight"].T + data["bias"])))
    for i, m in enumerate(NAMES):
        far = np.abs(p[:, i] - 0.5) > 1e-3
        g, w = (np.array(t[f"{m}_pos_logreg"]) for t in (got, want))
        assert (g[far] == w[far]).all()


def test_prediction_panels_match_jax(flagship, tmp_path, monkeypatch):
    import prediction_panels as jax_panels

    from mipheivit_tpu_torch.figures import prediction_panels

    ckpt, _ = flagship
    drawn = {"jax": [], "port": []}
    real = prediction_panels.render_panel

    def recording(tag, draw):
        def render(he, gt, pred, names, out_path):
            drawn[tag].append((he, gt, pred, list(names)))
            draw(he, gt, pred, names, out_path)
        return render

    monkeypatch.setattr(jax_panels, "render_panel", recording("jax", lambda *a: None))
    monkeypatch.setattr(prediction_panels, "render_panel", recording("port", real))
    args = ["--checkpoint_dir", str(ckpt), "--n_tiles", "2", "--seed", "1"]
    monkeypatch.setattr(sys, "argv", ["prediction_panels.py", *args,
                                      "--out_dir", str(tmp_path / "jax")])
    jax_panels.main()
    prediction_panels.main([*args, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert len(drawn["port"]) == len(drawn["jax"]) == 2
    for (he, gt, pred, names), (jhe, jgt, jpred, jnames) in zip(drawn["port"], drawn["jax"]):
        assert names == jnames == NAMES
        np.testing.assert_array_equal(he, jhe)
        np.testing.assert_array_equal(gt, jgt)
        assert pred.dtype == jpred.dtype == np.uint8 and pred.shape == (GEN_IMG, GEN_IMG, 3)
        assert np.abs(pred.astype(np.int32) - jpred.astype(np.int32)).max() <= 1
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["panel_0.png", "panel_1.png"]


def test_inference_hemit_matches_jax(tmp_path, monkeypatch):
    import cv2
    import inference_hemit as jax_hemit
    import jax
    import jax.numpy as jnp
    from test_smp_import import DEPTHS, DIMS, _emit_smp_state

    from mipheivit_tpu.models.smp_unet import UnetMultiHeads as JaxUnet
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.models.smp_unet import UnetMultiHeads
    from mipheivit_tpu_torch.scripts import inference_hemit

    tiny = dict(decoder_channels=(16, 8, 8, 8, 8), encoder_dims=DIMS, encoder_depths=DEPTHS)
    monkeypatch.setattr(jax_hemit, "UnetMultiHeads", lambda **kw: JaxUnet(**{**kw, **tiny}))
    monkeypatch.setattr(inference_hemit, "UnetMultiHeads",
                        lambda **kw: UnetMultiHeads(**{**kw, **tiny}))
    model = JaxUnet(encoder_name="convnext", out_chans=1, **tiny)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(
        jax.random.PRNGKey(0))
    sd = _emit_smp_state(jax.tree.map(np.asarray, variables["params"]),
                         jax.tree.map(np.asarray, variables["batch_stats"]), out_chans=1)
    ckpt = tmp_path / "model.safetensors"
    save_file({f"generator.{k}": v for k, v in sd.items()}, ckpt)

    ds = tmp_path / "ds"
    rng = np.random.default_rng(7)
    for sub in ("input", "label"):
        (ds / "test" / sub).mkdir(parents=True)
    for i in range(3):
        _write_png(ds / "test" / "input" / f"t{i}.png",
                   rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        _write_png(ds / "test" / "label" / f"t{i}.png",
                   rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
    args = ["--dataset_dir", str(ds), "--checkpoint_path", str(ckpt), "--batch_size", "3"]
    monkeypatch.setattr(sys, "argv", ["inference_hemit.py", *args,
                                      "--output_dir", str(tmp_path / "jax")])
    jax_hemit.main()
    inference_hemit.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    for i in range(3):
        for kind in ("real_A", "fake_B", "real_B"):
            want = cv2.imread(str(tmp_path / "jax" / "images" / f"{i}_{kind}.png"),
                              cv2.IMREAD_UNCHANGED).astype(np.int32)
            got = cv2.imread(str(tmp_path / "port" / "images" / f"{i}_{kind}.png"),
                             cv2.IMREAD_UNCHANGED).astype(np.int32)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= (1 if kind == "fake_B" else 0), (i, kind)
