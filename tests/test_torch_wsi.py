"""Stitched whole-slide inference in the port against the JAX package: the
numpy stitcher bit-equal to JAX's, ``wsi_inference`` within one uint8 step
of JAX's at S <= 512 (K1's path) and S > 512 (K4's path), the uint8 fetch,
the array sink, the ``--wsi`` CLI, and no silent CPU fallback."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.infer.loading as port_loading
from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference
from mipheivit_tpu_torch.infer.stitch import RollingAccumulator, blend_window
from mipheivit_tpu_torch.models import MipheiViT, ViTConfig
from mipheivit_tpu_torch.models.convert import state_dict_from_jax
from mipheivit_tpu_torch.ops import attention as port_attention

torch.set_num_threads(2)

NAMES = ["CD31", "CD3e", "Ki67"]
GEOM = dict(patch_size=4, embed_dim=128, depth=2, num_heads=2, mlp_hidden_dim=256,
            reg_tokens=4)
# (window, overlap, slide h x w, batch): 32-px windows give S = 8*8 + 5 = 69
# tokens (K1's range); 128-px windows give S = 32*32 + 5 = 1029 (K4's). The
# slides are ragged, so the last windows overhang them and the last batch is
# padded.
GEOMETRIES = {"s69": (32, 8, (88, 104), 4), "s1029": (128, 32, (200, 232), 3)}


def _normalizer():
    from mipheivit_tpu.data.stats import Normalizer

    return Normalizer({"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]}, "he")


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def models(request):
    """The same random weights as a JAX generator (attention in interpret
    mode: K1 at S = 69, K4 at S = 1029) and as the port's."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models import MipheiViT as JaxMipheiViT
    from mipheivit_tpu.models import ViTConfig as JaxViTConfig

    tile, overlap, shape, batch = GEOMETRIES[request.param]
    cfg = JaxViTConfig(img_size=(tile, tile), **GEOM, attn_impl="flash_interpret",
                       remat=False)
    jmodel = JaxMipheiViT(vit_cfg=cfg, out_chans=len(NAMES))
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmodel.init(k, jnp.zeros((1, tile, tile, 3)), train=False))(
            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    blocks = variables["params"]["encoder"]["vit"]["blocks"]
    for name in ("ls1", "ls2"):     # layerscale at a trained magnitude
        blocks[name] = rng.uniform(0.05, 0.15, blocks[name].shape).astype(np.float32)
    model = MipheiViT(ViTConfig(img_size=(tile, tile), **GEOM), len(NAMES)).eval()
    state = state_dict_from_jax(variables, cfg, len(NAMES))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return dict(jax=(jmodel, variables), port=model, tile=tile, overlap=overlap,
                shape=shape, batch=batch)


def _slide(tmp_path, shape, seed=5):
    from mipheivit_tpu.slideio import write_pyramid

    he = np.random.default_rng(seed).integers(60, 255, (3,) + shape, dtype=np.uint8)
    path = str(tmp_path / "slide.tiff")
    write_pyramid(path, he, n_levels=2, tile_size=32)
    return path, np.ascontiguousarray(he.transpose(1, 2, 0))


def _read(path):
    from mipheivit_tpu.slideio import TiffSlide

    ts = TiffSlide(path)
    try:
        return ts.read_region((0, 0), 0, ts.dimensions)
    finally:
        ts.close()


def _kwargs(m, **kw):
    return dict(tile_size=m["tile"], overlap=m["overlap"], batch_size=m["batch"],
                tissue_only=False, n_pyramid_levels=2, **kw)


# ---------------------------------------------------------------------------
# the stitcher


@pytest.mark.parametrize("tile,overlap,h,w", [(32, 8, 88, 104), (48, 16, 100, 61),
                                              (16, 0, 40, 40)])
@pytest.mark.parametrize("pre_windowed", [False, True])
def test_rolling_accumulator_bit_equal_to_jax(tile, overlap, h, w, pre_windowed):
    from mipheivit_tpu.infer.wsi import RollingAccumulator as JaxRolling
    from mipheivit_tpu.infer.wsi import _blend_window

    stride = tile - overlap
    rng = np.random.default_rng(tile + h)
    window = blend_window(tile, overlap)
    outs = [np.zeros((3, h, w), np.uint8) for _ in range(2)]
    accs = [RollingAccumulator(outs[0], tile, stride), JaxRolling(outs[1], tile, stride)]
    for ty in range(0, max(h - overlap, 1), stride):
        for tx in range(0, max(w - overlap, 1), stride):
            pred = rng.uniform(0, 255, (tile, tile, 3)).astype(np.float32)
            if pre_windowed:
                pred = pred * window[..., None]
            for acc in accs:
                acc.add(pred, tx, ty, _blend_window(tile, overlap), pre_windowed)
    for acc in accs:
        acc.finalize()
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].any()


@pytest.mark.parametrize("overlap", [0, 8, 32])
def test_blend_window_bit_equal_to_jax(overlap):
    from mipheivit_tpu.infer.wsi import _blend_window

    got = blend_window(128, overlap)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _blend_window(128, overlap))


def test_rolling_accumulator_rejects_out_of_order_tiles():
    acc = RollingAccumulator(np.zeros((1, 64, 64), np.uint8), 16, 8)
    acc.add(np.ones((16, 16, 1), np.float32), 0, 40, blend_window(16, 8))
    with pytest.raises(ValueError, match="raster"):
        acc.add(np.ones((16, 16, 1), np.float32), 0, 0, blend_window(16, 8))


# ---------------------------------------------------------------------------
# wsi_inference against the JAX package


def test_wsi_inference_matches_jax(models, tmp_path):
    from mipheivit_tpu.infer import wsi_inference as jax_wsi_inference

    path, _ = _slide(tmp_path, models["shape"])
    jmodel, variables = models["jax"]
    want = _read(jax_wsi_inference(jmodel, variables, path, str(tmp_path / "jax.ome.tiff"),
                                   NAMES, _normalizer(), **_kwargs(models)))
    port_attention.launch_counts.update(attention=0, flash=0, flash_bwd=0)
    stats = {}
    got = _read(wsi_inference(models["port"], path, str(tmp_path / "port.ome.tiff"), NAMES,
                              _normalizer(), stats=stats, **_kwargs(models)))
    assert port_attention.launch_counts == {"attention": 0, "flash": 0,  # plain on the CPU
                                            "flash_bwd": 0}
    assert got.shape == want.shape == models["shape"] + (3,)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (got.sum(axis=-1) > 0).mean() > 0.99       # no zero seams
    _check_stats(stats, models)


def test_wsi_inference_tissue_only_matches_jax(models, tmp_path):
    """Otsu tissue windows on a slide whose right part is blank glass."""
    from mipheivit_tpu.infer import wsi_inference as jax_wsi_inference
    from mipheivit_tpu.slideio import write_pyramid

    h, w = models["shape"]
    he = np.full((3, h, w), 235, np.uint8)
    he[:, :, :w // 2] = np.random.default_rng(8).integers(60, 160, (3, h, w // 2))
    path = str(tmp_path / "tissue.tiff")
    write_pyramid(path, he, n_levels=2, tile_size=32)
    kwargs = {**_kwargs(models), "tissue_only": True}
    jmodel, variables = models["jax"]
    want = _read(jax_wsi_inference(jmodel, variables, path, str(tmp_path / "jax.ome.tiff"),
                                   NAMES, _normalizer(), **kwargs))
    got = _read(wsi_inference(models["port"], path, str(tmp_path / "port.ome.tiff"), NAMES,
                              _normalizer(), **kwargs))
    assert want.any() and not want[:, -4:].any()     # tissue windows only
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _check_stats(stats, models):
    h, w = models["shape"]
    stride = models["tile"] - models["overlap"]
    n = len(range(0, h - models["overlap"], stride)) * len(range(0, w - models["overlap"], stride))
    assert stats["n_tiles"] == n and stats["n_batches"] == -(-n // models["batch"])
    assert set(stats) == {"n_tiles", "n_batches", "batch_size", "wall_s", "steady_s",
                          "steady_tiles", "steady_batches", "read_wait_s", "device_wait_s",
                          "stitch_s", "finalize_s"}


def test_fetch_uint8_within_one_step_of_f16_fetch(models, tmp_path):
    _, image = _slide(tmp_path, models["shape"], seed=6)
    outs = []
    for fetch_uint8 in (False, True):
        out = np.zeros((3,) + models["shape"], np.uint8)
        wsi_inference(models["port"], ArraySlide(image), out, NAMES, _normalizer(),
                      fetch_uint8=fetch_uint8, **_kwargs(models))
        outs.append(out.astype(np.int16))
    assert np.abs(outs[0] - outs[1]).max() <= 1


def test_array_sink_equals_pyramid_writer(models, tmp_path):
    path, image = _slide(tmp_path, models["shape"], seed=7)
    written = _read(wsi_inference(models["port"], path, str(tmp_path / "p.ome.tiff"),
                                  NAMES, _normalizer(), **_kwargs(models)))
    arr = np.zeros((3,) + models["shape"], np.uint8)
    assert wsi_inference(models["port"], ArraySlide(image), arr, NAMES, _normalizer(),
                         **_kwargs(models, read_workers=2, fetch_workers=1)) is arr
    np.testing.assert_array_equal(arr.transpose(1, 2, 0), written)


def test_array_slide_pads_past_the_edge():
    image = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    slide = ArraySlide(image)
    assert slide.level_dimensions == [(7, 5)]
    region = slide.read_region((4, 3), 0, (6, 4))
    assert region.shape == (4, 6, 3)
    np.testing.assert_array_equal(region[:2, :3], image[3:, 4:])
    assert not region[2:].any() and not region[:, 3:].any()


def test_wsi_inference_surfaces_reader_errors():
    class Broken(ArraySlide):
        def read_region(self, location, level, size):
            raise IOError("disk gone")

    model = MipheiViT(ViTConfig(img_size=(32, 32), **GEOM), 3).eval()
    with pytest.raises(IOError, match="disk gone"):
        wsi_inference(model, Broken(np.zeros((64, 64, 3), np.uint8)),
                      np.zeros((3, 64, 64), np.uint8), NAMES, _normalizer(),
                      tile_size=32, overlap=8, batch_size=2, tissue_only=False)


# ---------------------------------------------------------------------------
# the CLI, and no silent CPU


def _checkpoint(tmp_path, tile):
    from mipheivit_tpu.config import compose, save_config
    from mipheivit_tpu_torch.io.safetensors import save_file

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    model = MipheiViT(ViTConfig(img_size=(tile, tile), **GEOM, lora_rank=8), 3)
    save_file(model.state_dict(), ckpt / "model.safetensors")
    stats = {"RGB": {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]},
             **{m: {"idx_channel": i, "std": 10.0, "min": 0} for i, m in enumerate(NAMES)}}
    (tmp_path / "channel_stats.json").write_text(json.dumps(stats))
    (tmp_path / "test.csv").write_text("image_path\n")
    cfg = compose(["+default_configs=miphei-vit"])
    cfg.data.test_dataframe_path = str(tmp_path / "test.csv")
    cfg.data.channel_stats_path = str(tmp_path / "channel_stats.json")
    cfg.data.targ_channel_names = NAMES
    cfg.train.batch_size = 2
    save_config(cfg, ckpt / "config.yaml")
    return ckpt, cfg


def _tiny_generator(model_name, img_size, nc_out, encoder_name="hoptimus0",
                    dtype=torch.float32, device="cpu"):
    assert tuple(img_size) == (32, 32)      # loaded at (tile_size, tile_size)
    with torch.device(device):
        return MipheiViT(ViTConfig(img_size=tuple(img_size), **GEOM, lora_rank=8),
                         nc_out).to(dtype).eval()


def test_run_inference_cli_wsi(tmp_path, monkeypatch):
    from mipheivit_tpu.slideio import TiffSlide
    from mipheivit_tpu_torch import run_inference

    ckpt, _ = _checkpoint(tmp_path, 32)
    path, _ = _slide(tmp_path, (88, 104))
    monkeypatch.setattr(port_loading, "get_generator", _tiny_generator)
    out = run_inference.main(["--checkpoint_dir", str(ckpt), "--wsi", path,
                              "--out", str(tmp_path / "pred.ome.tiff"), "--tile_size", "32",
                              "--overlap", "8", "--device", "cpu"])
    assert Path(out) == tmp_path / "pred.ome.tiff"
    ts = TiffSlide(out)
    try:
        assert ts.n_channels == 3 and ts.level_dimensions[0] == (104, 88)
        assert ts.read_region((0, 0), 0, (104, 88)).any()
    finally:
        ts.close()


@pytest.mark.parametrize("flag", ["--int8", "--seq_shard"])
def test_run_inference_cli_refuses_unported_flags(tmp_path, flag):
    from mipheivit_tpu_torch import run_inference

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_inference.main(["--checkpoint_dir", str(tmp_path), "--wsi", "s.tiff", flag])


@pytest.mark.parametrize("entry", ["inference_model", "cli_tiles", "cli_wsi"])
def test_no_silent_cpu_without_a_card(tmp_path, monkeypatch, entry):
    from mipheivit_tpu_torch import run_inference
    from mipheivit_tpu_torch.infer import inference_model

    ckpt, cfg = _checkpoint(tmp_path, 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_loading, "get_generator", _tiny_generator)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "inference_model":
            inference_model(cfg, str(ckpt), str(tmp_path / "out"))
        elif entry == "cli_tiles":
            run_inference.main(["--checkpoint_dir", str(ckpt)])
        else:
            run_inference.main(["--checkpoint_dir", str(ckpt), "--wsi", "slide.tiff"])
