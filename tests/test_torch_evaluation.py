"""The port's evaluation scripts against the JAX package's, on the CPU.

The fixture of ``tests/test_evaluation.py`` (a tiny MIPHEI-ViT exported by
the JAX package, PNG tiles and TIFF nuclei of 32 px over a val and a test
slide, marker intensities tied to the nuclei CSVs' ground truth) goes
through ``evaluation/eval_{orion,immucan,hemit}.py``'s ``main()`` and the
port's ``mipheivit_tpu_torch.evaluation.eval_*.run()`` (``main()`` once,
for the CLI). Every CSV is parsed and compared by column: the same columns
and rows, integers and names equal, the cell means within 1 / (min_area +
1) + 1e-6 (one quantisation step of the ``* 255`` sums over the smallest
area kept), the AUCs within 2e-3 and the balanced accuracies,
F1 scores and Pearson correlations within 1e-2 (the tolerances of
``tests/test_torch_cell_metrics.py``). The ``Table`` operations the cell
frames use are held against pandas.
"""

import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.infer.loading as port_loading
from mipheivit_tpu_torch.config import load_yaml, save_config
from mipheivit_tpu_torch.data.table import Table
from mipheivit_tpu_torch.evaluation import common, eval_hemit, eval_immucan, eval_orion

import torch_synthetic_run as syn

torch.set_num_threads(2)

EVAL_DIR = Path(__file__).resolve().parent.parent / "evaluation"
MARKERS = ["Hoechst", "CD31", "CD3e"]
MEAN_ATOL = 1.0 / 21 + 1e-6     # one step of the * 255 sums over a cell of area > 20
AUC_ATOL, HARD_ATOL = 2e-3, 1e-2


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """The checkpoint dir and ORION-like tiles of tests/test_evaluation.py."""
    import cv2
    import jax
    import jax.numpy as jnp
    import pandas as pd

    from mipheivit_tpu.config import compose, save_config
    from mipheivit_tpu.models import MipheiViT, ViTConfig
    from mipheivit_tpu.slideio import write_pyramid
    from mipheivit_tpu.train.checkpoints import mipheivit_state_dict, save_safetensors

    tmp_path = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    vit_cfg = ViTConfig(img_size=(32, 32), patch_size=4, embed_dim=32, depth=2, num_heads=2,
                        mlp_hidden_dim=64, reg_tokens=4, attn_impl="xla", remat=False,
                        lora_rank=8)
    model = MipheiViT(vit_cfg=vit_cfg, out_chans=3)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    save_safetensors(mipheivit_state_dict(params, stats, vit_cfg, 3),
                     str(ckpt_dir / "model.safetensors"))

    tiles = tmp_path / "tiles"
    tiles.mkdir()
    rows = {"val": [], "test": []}
    cells = {"sval": [], "stest": []}
    label = 1
    for split, slide in (("val", "sval"), ("test", "stest")):
        for i in range(4):
            he = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            nuc = np.zeros((1, 32, 32), np.int32)
            for j in range(2):
                nuc[0, 4 + 12 * j:14 + 12 * j, 4:30] = label
                cells[slide].append({"label": label, "CD31_pos": label % 2 == 0,
                                     "CD3e_pos": label % 3 == 0})
                label += 1
            img = str(tiles / f"{split}{i}.png")
            cv2.imwrite(img, cv2.cvtColor(he, cv2.COLOR_RGB2BGR))
            nucp = str(tiles / f"{split}{i}_nuc.tiff")
            write_pyramid(nucp, nuc, n_levels=1, tile_size=32)
            rows[split].append({"image_path": img, "nuclei_path": nucp, "in_slide_name": slide})
    for split in ("val", "test"):
        pd.DataFrame(rows[split]).to_csv(tmp_path / f"{split}.csv", index=False)
    slide_rows = []
    for slide in ("sval", "stest"):
        path = tmp_path / f"{slide}_cells.csv"
        pd.DataFrame(cells[slide]).to_csv(path, index=False)
        slide_rows.append({"in_slide_name": slide, "nuclei_csv_path": str(path)})
    pd.DataFrame(slide_rows).to_csv(tmp_path / "slides.csv", index=False)
    stats_json = {"RGB": {"mean": [180.0] * 3, "std": [40.0] * 3}}
    for i, name in enumerate(MARKERS):
        stats_json[name] = {"idx_channel": i, "std": 10.0, "min": 0, "is_structural": False}
    (tmp_path / "channel_stats.json").write_text(json.dumps(stats_json))

    cfg = compose(["+default_configs=miphei-vit"])
    cfg.data.slide_dataframe_path = str(tmp_path / "slides.csv")
    cfg.data.train_dataframe_path = str(tmp_path / "val.csv")
    cfg.data.val_dataframe_path = str(tmp_path / "val.csv")
    cfg.data.test_dataframe_path = str(tmp_path / "test.csv")
    cfg.data.channel_stats_path = str(tmp_path / "channel_stats.json")
    cfg.data.targ_channel_names = MARKERS
    cfg.train.batch_size = 2
    save_config(cfg, ckpt_dir / "config.yaml")

    test_df = pd.read_csv(tmp_path / "test.csv")
    test_df["CD3e_count"] = np.arange(len(test_df))
    test_df["CD31_count"] = np.arange(len(test_df))[::-1]
    test_df.to_csv(tmp_path / "immucan.csv", index=False)
    return ckpt_dir, tmp_path, vit_cfg


@pytest.fixture
def tiny(eval_setup, monkeypatch):
    """Both packages' ``load_generator`` build the fixture's tiny ViT at the
    size asked for (eval_hemit builds at half resolution; the position
    embedding is resampled on import)."""
    import mipheivit_tpu.infer.loading as jax_loading
    from mipheivit_tpu.models import MipheiViT as JaxMipheiViT
    from mipheivit_tpu_torch.models import MipheiViT, ViTConfig

    _, _, vit_cfg = eval_setup

    def jax_builder(cfg, img_size, nc_out, dtype="float32"):
        size = tuple(img_size) if not isinstance(img_size, int) else (img_size, img_size)
        return JaxMipheiViT(vit_cfg=vit_cfg.replace(img_size=size), out_chans=nc_out)

    def port_builder(model_name, img_size, nc_out, encoder_name="hoptimus0",
                     dtype=torch.float32, device="cpu", **family_options):
        size = tuple(img_size) if not isinstance(img_size, int) else (img_size, img_size)
        with torch.device(device):
            return MipheiViT(ViTConfig(**dict(syn.TINY, img_size=size, lora_rank=8)),
                             nc_out).eval()

    monkeypatch.setattr(jax_loading, "build_generator", jax_builder)
    monkeypatch.setattr(port_loading, "get_generator", port_builder)
    monkeypatch.syspath_prepend(str(EVAL_DIR))


def _dirs(eval_setup, tmp_path, train_csv=None):
    """Two copies of the checkpoint dir, one for each package; optionally
    with another train dataframe in its config."""
    from mipheivit_tpu.config import load_yaml as jax_load_yaml
    from mipheivit_tpu.config import save_config

    ckpt_dir, _, _ = eval_setup
    out = {}
    for side in ("jax", "port"):
        out[side] = tmp_path / side
        shutil.copytree(ckpt_dir, out[side])
        cfg = jax_load_yaml(out[side] / "config.yaml")
        if train_csv:
            cfg.data.train_dataframe_path = str(train_csv)
        save_config(cfg, out[side] / "config.yaml")
    return out


def _run_jax(script: str, ckpt_dir: Path, monkeypatch):
    import importlib

    module = importlib.import_module(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", "--checkpoint_dir", str(ckpt_dir),
                                      "--dataset_config_path", "/nonexistent.yaml",
                                      "--batch_size", "2"])
    module.main()


def _run_port(module, ckpt_dir: Path):
    cfg = common.load_eval_config(str(ckpt_dir), "/nonexistent.yaml")
    return module.run(cfg, str(ckpt_dir), batch_size=2, device="cpu")


def _float_atol(col: str) -> float:
    if col.endswith("_pred"):
        return MEAN_ATOL
    if "AUC" in col:
        return AUC_ATOL
    return HARD_ATOL


def assert_csvs_match(got_path: Path, want_path: Path):
    """Parsed by column: the same columns and rows, the non-float columns
    equal, each float column within its tolerance."""
    got, want = Table.read_csv(got_path), Table.read_csv(want_path)
    assert got.columns == want.columns, (got.columns, want.columns)
    assert len(got) == len(want) > 0
    for col in want.columns:
        if want[col].dtype.kind == "f":
            assert got[col].dtype.kind == "f", col
            np.testing.assert_allclose(got[col], want[col], rtol=0, atol=_float_atol(col),
                                       err_msg=f"{got_path.name}: {col}")
        else:
            assert got[col].tolist() == want[col].tolist(), (got_path.name, col)


def test_eval_orion_matches_jax(eval_setup, tiny, tmp_path, monkeypatch):
    dirs = _dirs(eval_setup, tmp_path)
    _run_jax("eval_orion", dirs["jax"], monkeypatch)
    out = _run_port(eval_orion, dirs["port"])
    for name in ("results_logreg.csv", "cell_dataframe.csv"):
        assert_csvs_match(dirs["port"] / name, dirs["jax"] / name)
    assert set(out["results"]["Marker"].tolist()) == {"CD31_pos", "CD3e_pos"}
    npz = np.load(dirs["port"] / "logreg.npz")
    pth = torch.load(dirs["port"] / "logreg.pth", weights_only=True)
    assert npz["weight"].shape == (2, 2) and npz["bias"].shape == (2,)
    np.testing.assert_array_equal(pth["weight"].numpy(), npz["weight"])
    np.testing.assert_array_equal(pth["bias"].numpy(), npz["bias"])
    assert not (dirs["port"] / "results_xgboost.csv").exists()


def test_eval_orion_cli(eval_setup, tiny, tmp_path, capsys):
    """``python -m mipheivit_tpu_torch.evaluation.eval_orion`` in-process."""
    dirs = _dirs(eval_setup, tmp_path)
    out = eval_orion.main(["--checkpoint_dir", str(dirs["port"]), "--dataset_config_path",
                           "/nonexistent.yaml", "--batch_size", "2", "--device", "cpu"])
    assert "mean AUC" in capsys.readouterr().out
    assert np.isfinite(out["results"]["ROC AUC"]).all()
    assert (dirs["port"] / "cell_dataframe.csv").exists()


def test_eval_immucan_matches_jax(eval_setup, tiny, tmp_path, monkeypatch):
    """After eval_orion's logreg (each package its own), per-tile pooling
    and the Pearson correlations."""
    _, base, _ = eval_setup
    dirs = _dirs(eval_setup, tmp_path)
    _run_jax("eval_orion", dirs["jax"], monkeypatch)
    _run_port(eval_orion, dirs["port"])
    for side in dirs:
        cfg = load_yaml(dirs[side] / "config.yaml")
        cfg.data.test_dataframe_path = str(base / "immucan.csv")
        save_config(cfg, dirs[side] / "config.yaml")
    _run_jax("eval_immucan", dirs["jax"], monkeypatch)
    out = _run_port(eval_immucan, dirs["port"])
    for name in ("immucan_corr.csv", "immucan_tile_sums.csv"):
        assert_csvs_match(dirs["port"] / name, dirs["jax"] / name)
    assert "CD3e" in out["corr"]["Marker"].tolist()
    assert "CD3e_pos_logreg" in out["tile_sums"].columns


def test_eval_immucan_reads_the_pth_head(eval_setup, tmp_path):
    """Without ``logreg.npz`` the head comes from ``logreg.pth``; without
    either, it raises."""
    d = tmp_path / "ckpt"
    d.mkdir()
    with pytest.raises(FileNotFoundError, match="eval_orion"):
        eval_immucan.load_logreg(str(d))
    w, b = np.arange(4, dtype=np.float32).reshape(2, 2), np.ones(2, np.float32)
    torch.save({"weight": torch.tensor(w), "bias": torch.tensor(b)}, d / "logreg.pth")
    head = eval_immucan.load_logreg(str(d))
    np.testing.assert_array_equal(head.weight, w)
    np.testing.assert_array_equal(head.bias, b)


def test_eval_hemit_matches_jax(eval_setup, tiny, tmp_path, monkeypatch):
    """The half-resolution forward (bilinear down and up) and the fit on a
    sample of the train slides' cells (the val tiles stand in for them)."""
    _, base, _ = eval_setup
    dirs = _dirs(eval_setup, tmp_path, train_csv=base / "val.csv")
    _run_jax("eval_hemit", dirs["jax"], monkeypatch)
    out = _run_port(eval_hemit, dirs["port"])
    for name in ("hemit_results_logreg_val.csv", "hemit_results_logreg_test.csv",
                 "hemit_cell_dataframe.csv"):
        assert_csvs_match(dirs["port"] / name, dirs["jax"] / name)
    assert np.isfinite(out["test"]["ROC AUC"]).all()


@pytest.mark.parametrize("name", ["orion", "immucan", "hemit"])
def test_load_eval_config_matches_jax(eval_setup, name):
    """The dataset configs' paths over the checkpoint's config, as the JAX
    ``load_eval_config`` lays them (ORION's file has no ``data`` group)."""
    sys.path.insert(0, str(EVAL_DIR))
    from common import load_eval_config as jax_load_eval_config

    ckpt_dir, _, _ = eval_setup
    want = jax_load_eval_config(str(ckpt_dir), str(
        Path(__file__).resolve().parent.parent / f"mipheivit_tpu/configs/data/{name}.yaml"))
    got = common.load_eval_config(str(ckpt_dir), str(common.DATA_CONFIGS / f"{name}.yaml"))
    assert got.to_dict()["data"] == dict(want["data"])


# -- the Table operations of the cell frames, against pandas ----------------

def _pandas_table(frame) -> Table:
    return Table({c: frame[c].to_numpy() for c in frame.columns})


def test_table_groupby_sum_matches_pandas():
    import pandas as pd

    rng = np.random.default_rng(0)
    n = 500
    frame = pd.DataFrame({"tile": rng.choice(["b", "a", "c"], n), "id": rng.integers(0, 40, n)
                          .astype(np.uint64), "x": rng.standard_normal(n),
                          "flag": rng.random(n) < 0.3, "k": rng.integers(0, 9, n)})
    table = _pandas_table(frame)
    for keys in (["id"], ["tile"], ["tile", "id"]):
        want = frame.groupby(keys)[["x", "flag", "k"]].sum().reset_index()
        got = table.groupby_sum(keys, ["x", "flag", "k"])
        assert got.columns == list(want.columns)
        for col in keys + ["flag", "k"]:
            assert got[col].tolist() == want[col].tolist(), (keys, col)
        np.testing.assert_allclose(got["x"], want["x"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("how", ["left", "inner"])
def test_table_merge_matches_pandas(how):
    """Duplicate right keys repeat the left row, a missing one gives NaN
    (int and bool columns become float and object) or drops it."""
    import pandas as pd

    left = pd.DataFrame({"cell_id": np.uint64([5, 1, 9, 1, 7]), "p": [0.1, 0.2, 0.3, 0.4, 0.5],
                         "slide_name": ["s1", "s0", "s0", "s1", "s0"]})
    right = pd.DataFrame({"label": [1, 5, 9, 1, 7], "pos": [True, False, True, False, True],
                          "slide_name": ["s0", "s1", "s0", "s0", "s1"]})
    want = left.merge(right, left_on=["slide_name", "cell_id"],
                      right_on=["slide_name", "label"], how=how)
    got = _pandas_table(left).merge(_pandas_table(right), ["slide_name", "cell_id"],
                                    ["slide_name", "label"], how=how)
    assert got.columns == list(want.columns)
    assert got["cell_id"].tolist() == want["cell_id"].tolist()
    assert got["slide_name"].tolist() == want["slide_name"].tolist()
    np.testing.assert_array_equal(got["label"], want["label"].to_numpy())
    assert got["label"].dtype == want["label"].dtype
    assert [None if v != v else v for v in got["pos"].tolist()] == [
        None if v != v else v for v in want["pos"].tolist()]


def test_table_concat_isin_rename_sample_to_csv_match_pandas(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(1)
    a = pd.DataFrame({"name": ["x", "y", "z"], "v": [1.5, np.nan, 2.25], "n": [1, 2, 3],
                      "b": [True, False, True]})
    b = pd.DataFrame({"name": ["w"], "v": [0.1], "n": [4], "b": [False]})
    want = pd.concat((a, b))
    got = Table.concat([_pandas_table(a), _pandas_table(b)])
    assert got["name"].tolist() == want["name"].tolist()
    np.testing.assert_array_equal(got.isin("name", ["y", "w"]), want["name"].isin(["y", "w"]))
    assert got.rename({"n": "count"}).columns == list(want.rename(columns={"n": "count"}).columns)
    assert got.drop(["v"]).columns == list(want.drop(columns=["v"]).columns)
    big = pd.DataFrame({"i": np.arange(200), "f": rng.standard_normal(200)})
    assert _pandas_table(big).sample(17, random_state=42)["i"].tolist() == \
        big.sample(n=17, random_state=42)["i"].tolist()
    got.to_csv(tmp_path / "got.csv")
    buf = io.StringIO()
    want.to_csv(buf, index=False)
    text = (tmp_path / "got.csv").read_text()
    assert text.splitlines()[0] == buf.getvalue().splitlines()[0]
    assert [line.split(",")[3] for line in text.splitlines()[1:]] == ["True", "False", "True",
                                                                      "False"]
    back = pd.read_csv(tmp_path / "got.csv")
    pd.testing.assert_frame_equal(back, pd.read_csv(io.StringIO(buf.getvalue())))


# -- the HEMIT-pipeline scripts: a HEMIT-codebase checkpoint ----------------

HEMIT_SWIN = dict(patch_size=2, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                  window_size=4)


@pytest.fixture
def hemit_tiny(eval_setup, monkeypatch):
    """Both packages build a tiny dual-branch generator wherever the
    pipeline scripts build ``build_hemit`` / ``build_hemit_netG`` (ngf 8,
    one ResNet block, a Swin of patch 2: the fixture's 32-px tiles and the
    16 px of eval_hemit's half resolution keep four stages). The JAX
    script's imported tree is handed over as device arrays (ROADMAP.md
    queue 3: as numpy arrays its jitted forward raises)."""
    from mipheivit_tpu.models.hemit import ResnetGeneratorSwinT as JG
    from mipheivit_tpu.models.swin import SwinConfig as JC
    from mipheivit_tpu_torch.evaluation import eval_orion_hemit_pipeline as port_pipeline
    from mipheivit_tpu_torch.models.hemit import ResnetGeneratorSwinT
    from mipheivit_tpu_torch.models.swin import SwinConfig

    monkeypatch.syspath_prepend(str(EVAL_DIR))
    import eval_orion_hemit_pipeline as jax_pipeline

    def jax_builder(img_size, nc_in, nc_out, cfg=None, dtype="float32"):
        return JG(out_channels=nc_out, ngf=8, n_blocks=1,
                  swin_cfg=JC(img_size=(img_size, img_size), **HEMIT_SWIN))

    def port_builder(netG, img_size, nc_in=3, nc_out=3, **kw):
        assert netG == "SwinTResnet"
        return ResnetGeneratorSwinT(nc_out, img_size, ngf=8, n_blocks=1,
                                    swin_cfg=SwinConfig(img_size=(img_size, img_size),
                                                        **HEMIT_SWIN))

    def jax_import(*args, **kw):
        # the JAX script jits a closure over the importer's numpy arrays, and
        # a numpy bias table indexed by a traced index raises
        # (TracerArrayConversionError); as device arrays they run
        import jax
        import jax.numpy as jnp

        return jax.tree.map(jnp.asarray, import_hemit(*args, **kw))

    import_hemit = jax_pipeline.hemit_swint_from_torch
    monkeypatch.setattr(jax_pipeline, "build_hemit", jax_builder)
    monkeypatch.setattr(jax_pipeline, "hemit_swint_from_torch", jax_import)
    monkeypatch.setattr(port_pipeline, "build_hemit_netG", port_builder)
    return jax_builder, port_builder


def _hemit_dirs(eval_setup, tmp_path, hemit_tiny, train_csv=None):
    """``_dirs`` with a HEMIT-codebase ``latest_net_G.pth`` (the older timm
    layout, written from seeded JAX variables of the tiny generator at the
    tiles' 32 px) in each."""
    from test_torch_hemit_import import _reference_layout
    from torch_family_helpers import init_jax

    jax_builder, port_builder = hemit_tiny
    v = init_jax(jax_builder(32, 3, len(MARKERS)), np.zeros((1, 32, 32, 3), np.float32), 8,
                 train=False)
    sd = _reference_layout(v, port_builder("SwinTResnet", 32, 3, len(MARKERS)), "swinT.",
                           old_timm_layout=True)
    dirs = _dirs(eval_setup, tmp_path, train_csv)
    for d in dirs.values():
        torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
                   d / "latest_net_G.pth")
    return dirs


def test_eval_orion_hemit_pipeline_matches_jax(eval_setup, hemit_tiny, tmp_path, monkeypatch):
    from mipheivit_tpu_torch.evaluation import eval_orion_hemit_pipeline

    dirs = _hemit_dirs(eval_setup, tmp_path, hemit_tiny)
    _run_jax("eval_orion_hemit_pipeline", dirs["jax"], monkeypatch)
    out = _run_port(eval_orion_hemit_pipeline, dirs["port"])
    for name in ("results_logreg.csv", "cell_dataframe.csv"):
        assert_csvs_match(dirs["port"] / name, dirs["jax"] / name)
    assert np.isfinite(out["results"]["ROC AUC"]).all()


def test_eval_immucan_hemit_pipeline_matches_jax(eval_setup, hemit_tiny, tmp_path, monkeypatch):
    """After the ORION pipeline's logreg (each package its own), the
    pix2pix-normalised per-tile pooling and the Pearson correlations."""
    from mipheivit_tpu_torch.evaluation import (eval_immucan_hemit_pipeline,
                                                eval_orion_hemit_pipeline)

    _, base, _ = eval_setup
    dirs = _hemit_dirs(eval_setup, tmp_path, hemit_tiny)
    _run_jax("eval_orion_hemit_pipeline", dirs["jax"], monkeypatch)
    _run_port(eval_orion_hemit_pipeline, dirs["port"])
    for side in dirs:
        cfg = load_yaml(dirs[side] / "config.yaml")
        cfg.data.test_dataframe_path = str(base / "immucan.csv")
        save_config(cfg, dirs[side] / "config.yaml")
    _run_jax("eval_immucan_hemit_pipeline", dirs["jax"], monkeypatch)
    out = _run_port(eval_immucan_hemit_pipeline, dirs["port"])
    for name in ("immucan_corr.csv", "immucan_tile_sums.csv"):
        assert_csvs_match(dirs["port"] / name, dirs["jax"] / name)
    assert "CD3e" in out["corr"]["Marker"].tolist()


def test_eval_hemit_hemit_pipeline_matches_jax(eval_setup, hemit_tiny, tmp_path, monkeypatch,
                                               capsys):
    """The generator built at half the tile width (its bias tables resampled
    on import), through ``main()`` with ``--device cpu``."""
    from mipheivit_tpu_torch.evaluation import eval_hemit_hemit_pipeline

    _, base, _ = eval_setup
    dirs = _hemit_dirs(eval_setup, tmp_path, hemit_tiny, train_csv=base / "val.csv")
    _run_jax("eval_hemit_hemit_pipeline", dirs["jax"], monkeypatch)
    out = eval_hemit_hemit_pipeline.main(
        ["--checkpoint_dir", str(dirs["port"]), "--dataset_config_path", "/nonexistent.yaml",
         "--batch_size", "2", "--device", "cpu"])
    for name in ("hemit_results_logreg_val.csv", "hemit_results_logreg_test.csv"):
        assert_csvs_match(dirs["port"] / name, dirs["jax"] / name)
    assert np.isfinite(out["test"]["ROC AUC"]).all()
    assert "ROC AUC" in capsys.readouterr().out


def test_hemit_pipeline_finds_the_checkpoint_or_raises(tmp_path):
    from mipheivit_tpu_torch.evaluation.eval_orion_hemit_pipeline import build_hemit_forward

    with pytest.raises(FileNotFoundError, match="HEMIT generator checkpoint"):
        build_hemit_forward(str(tmp_path), 32, 3, device="cpu")
    torch.save({}, tmp_path / "net_G.pth")
    with pytest.raises(NotImplementedError, match="resnet_9blocks"):
        build_hemit_forward(str(tmp_path), 32, 3, netG="resnet_9blocks", device="cpu")
