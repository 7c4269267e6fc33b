"""Tile inference in the port: batching with a padded ragged batch, the
uint8 output codec, and the tile-mode CLI end to end on the CPU."""

import json
import sys
from pathlib import Path

import numpy as np
import torch

import mipheivit_tpu_torch.infer.loading as port_loading
from mipheivit_tpu_torch.infer.tiles import (HOPTIMUS_HE, _to_uint8, predict_tiles,
                                             predictions_to_uint8)
from mipheivit_tpu_torch.models import MipheiViT, ViTConfig

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
from make_parity_fixtures import synth_state_dict  # noqa: E402

torch.set_num_threads(2)

GEOM = dict(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2, num_heads=2,
            mlp_hidden_dim=256, reg_tokens=4)


def _model(nc=3, lora=0):
    model = MipheiViT(ViTConfig(**GEOM, lora_rank=lora), nc).eval()
    keys = [(k, tuple(v.shape)) for k, v in model.state_dict().items()
            if v.is_floating_point()]
    model.load_state_dict({k: torch.from_numpy(v) for k, v in synth_state_dict(keys).items()},
                          strict=False)
    return model


def test_predict_tiles_batched_equals_one_at_a_time():
    model = _model()
    tiles = np.random.default_rng(0).integers(0, 256, (37, 32, 32, 3), dtype=np.uint8)
    batched = predict_tiles(model, tiles, HOPTIMUS_HE, batch_size=16)
    assert batched.shape == (37, 32, 32, 3) and batched.dtype == np.uint8
    single = np.concatenate([predict_tiles(model, t[None], HOPTIMUS_HE, batch_size=1)
                             for t in tiles])
    np.testing.assert_array_equal(batched, single)


def test_predict_tiles_matches_host_normalized_forward():
    """Device-side (x - mean) / std and uint8 codec equal the host pipeline
    of the JAX package's Normalizer + predictions_to_uint8."""
    from mipheivit_tpu.data.stats import HOPTIMUS_MEAN, HOPTIMUS_STD, Normalizer

    norm = Normalizer({"mean": HOPTIMUS_MEAN, "std": HOPTIMUS_STD}, mode="he")
    model = _model()
    tiles = np.random.default_rng(1).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    got = predict_tiles(model, tiles, norm, batch_size=8)
    with torch.inference_mode():
        pred = model(torch.from_numpy(norm(tiles.astype(np.float32)))).numpy()
    np.testing.assert_array_equal(got, predictions_to_uint8(pred))


def test_predictions_to_uint8_matches_jax_package():
    from mipheivit_tpu.infer.tiles import predictions_to_uint8 as jax_to_uint8

    pred = np.random.default_rng(2).uniform(-1.2, 1.2, (4, 8, 8, 16)).astype(np.float32)
    pred[0, 0, 0, :3] = [-0.9, 0.9, 0.0]
    want = jax_to_uint8(pred)
    np.testing.assert_array_equal(predictions_to_uint8(pred), want)
    np.testing.assert_array_equal(_to_uint8(torch.from_numpy(pred)).numpy(), want)


def test_run_inference_cli_writes_tiles(tmp_path, monkeypatch):
    """config.yaml + model.safetensors checkpoint dir and a tile dataframe
    -> one multi-channel uint8 TIFF per tile."""
    import cv2

    from mipheivit_tpu.config import compose, save_config
    from mipheivit_tpu.slideio import TiffSlide
    from mipheivit_tpu_torch import run_inference
    from mipheivit_tpu_torch.io.safetensors import save_file

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    save_file(_model(lora=8).state_dict(), ckpt / "model.safetensors")
    rng = np.random.default_rng(3)
    rows = ["image_path"]
    for i in range(5):
        path = tmp_path / f"t{i}.png"
        cv2.imwrite(str(path), rng.integers(0, 255, (40, 36, 3), dtype=np.uint8))
        rows.append(str(path))
    (tmp_path / "test.csv").write_text("\n".join(rows) + "\n")
    stats = {"RGB": {"mean": [180.0, 140.0, 170.0], "std": [40.0, 45.0, 35.0]},
             **{m: {"idx_channel": i, "std": 10.0, "min": 0}
                for i, m in enumerate(("CD31", "CD3e", "Ki67"))}}
    (tmp_path / "channel_stats.json").write_text(json.dumps(stats))
    cfg = compose(["+default_configs=miphei-vit"])
    cfg.data.test_dataframe_path = str(tmp_path / "test.csv")
    cfg.data.channel_stats_path = str(tmp_path / "channel_stats.json")
    cfg.data.targ_channel_names = ["CD31", "CD3e", "Ki67"]
    cfg.train.batch_size = 2
    save_config(cfg, ckpt / "config.yaml")

    def tiny(model_name, img_size, nc_out, encoder_name="hoptimus0",
             dtype=torch.float32, device="cpu"):
        assert tuple(img_size) == (32, 32)     # 40x36 tiles snap to 32x32
        return MipheiViT(ViTConfig(**GEOM, lora_rank=8), nc_out).eval()

    monkeypatch.setattr(port_loading, "get_generator", tiny)
    out_dir = run_inference.main(["--checkpoint_dir", str(ckpt), "--device", "cpu"])
    outs = sorted(Path(out_dir).glob("*.tiff"))
    assert [p.stem for p in outs] == [f"t{i}" for i in range(5)]
    ts = TiffSlide(str(outs[0]))
    try:
        assert ts.n_channels == 3
        assert ts.read_region((0, 0), 0, (32, 32)).dtype == np.uint8
    finally:
        ts.close()

