"""The port's own copies of the JAX package's host modules (slide IO,
channel statistics, run configs) against the originals."""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch import slideio as port_slideio
from mipheivit_tpu_torch.data import stats as port_stats


def test_write_pyramid_and_read_image_round_trip_across_packages(tmp_path):
    """A TIFF written by either package reads back bit-identical through
    either package's ``read_image``, and the two writers produce the same
    bytes."""
    from mipheivit_tpu import slideio as jax_slideio

    rgb = np.random.default_rng(1).integers(0, 255, (3, 128, 96), dtype=np.uint8)
    ours, theirs = tmp_path / "port.tiff", tmp_path / "jax.tiff"
    port_slideio.write_pyramid(str(ours), rgb, n_levels=2, tile_size=64)
    jax_slideio.write_pyramid(str(theirs), rgb, n_levels=2, tile_size=64)
    assert ours.read_bytes() == theirs.read_bytes()
    want = np.moveaxis(rgb, 0, -1)
    for reader in (port_slideio.read_image, jax_slideio.read_image):
        for path in (ours, theirs):
            np.testing.assert_array_equal(reader(str(path)), want)
    # the port builds its engine into its own build dir, never beside the source
    from mipheivit_tpu_torch.slideio.native import build as native

    assert native.library_path().exists()
    assert native.library_path().parent.name == "build"
    assert not list(native._NATIVE_DIR.glob("*.so"))


def test_get_locs_otsu_matches_jax_package():
    from mipheivit_tpu.slideio import get_locs_otsu

    rng = np.random.default_rng(2)
    thumb = rng.integers(200, 230, (120, 90, 3)).astype(np.uint8)      # pale background
    thumb[30:90, 20:70] = rng.integers(0, 255, (60, 50, 3))             # textured tissue
    for arg in (thumb, thumb.std(axis=-1) > 20):
        want = get_locs_otsu(arg, slide_dim=(900, 1200), tile_size_lvl0=100,
                             tile_overlap=10, mask_thresh=0.1)
        got = port_slideio.get_locs_otsu(arg, slide_dim=(900, 1200), tile_size_lvl0=100,
                                         tile_overlap=10, mask_thresh=0.1)
        assert len(got[0]) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_normalizer_matches_jax_package_on_numpy_and_torch():
    from mipheivit_tpu.data import stats as jax_stats

    tile = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    rgb = {"mean": [180.0, 150.0, 170.0], "std": [50.0, 55.0, 45.0]}
    for model, enc in (("myvitmatte", "hoptimus0"), ("myvitmatte", "univ2"), ("unet", None)):
        stats = port_stats.get_input_mean_std(model, enc, rgb)
        want_stats = jax_stats.get_input_mean_std(model, enc, rgb)
        for key in ("mean", "std"):
            np.testing.assert_array_equal(stats[key], want_stats[key])
        he, want_he = port_stats.Normalizer(stats), jax_stats.Normalizer(want_stats)
        np.testing.assert_array_equal(he(tile), want_he(tile))
        np.testing.assert_array_equal(he(tile[0]), want_he(tile[0]))
        # the port's codec also takes torch tensors: the same f32 arithmetic
        np.testing.assert_array_equal(he(torch.from_numpy(tile)).numpy(), want_he(tile))
    mif, want_mif = port_stats.Normalizer(mode="if"), jax_stats.Normalizer(mode="if")
    np.testing.assert_array_equal(mif(tile), want_mif(tile))
    np.testing.assert_allclose(mif.unormalize(mif(tile)), want_mif.unormalize(want_mif(tile)))
    assert port_stats.get_effective_width_height(300, 700, train=True) == \
        jax_stats.get_effective_width_height(300, 700, train=True)


def test_channel_stats_and_config_match_jax_package(tmp_path):
    import json

    from mipheivit_tpu import config as jax_config
    from mipheivit_tpu.data import stats as jax_stats
    from mipheivit_tpu_torch import config as port_config

    raw = {"RGB": {"mean": [1, 2, 3], "std": [4, 5, 6]},
           "CD3": {"idx_channel": 2, "std": 0.5, "min": 0.0, "is_structural": True},
           "DAPI": {"idx_channel": 0, "std": 0.25, "min": 0.1}}
    path = tmp_path / "channel_stats.json"
    path.write_text(json.dumps(raw))
    got, want = port_stats.load_channel_stats(str(path)), jax_stats.load_channel_stats(str(path))
    names = ["DAPI", "CD3"]
    assert got.channel_idxs(names) == want.channel_idxs(names)
    np.testing.assert_array_equal(got.stds(names), want.stds(names))
    np.testing.assert_array_equal(got.structural_mask(names), want.structural_mask(names))

    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text("model:\n  model_name: myvitmatte\n  encoder:\n    encoder_name: "
                         "hoptimus0\ntrain:\n  batch_size: 8\n  losses: {lambda_factor: 50}\n")
    cfg, want_cfg = port_config.load_yaml(yaml_path), jax_config.load_yaml(yaml_path)
    assert cfg == want_cfg
    assert cfg.model.encoder.encoder_name == "hoptimus0"
    for key in ("train.losses.lambda_factor", "train.grad_accum_steps", "model.model_name"):
        assert cfg.select(key, 1) == want_cfg.select(key, 1)
    with pytest.raises(AttributeError):
        cfg.nothing
