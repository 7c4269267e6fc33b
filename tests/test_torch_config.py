"""The port's run configs against the JAX package's: ``compose``,
``compose_multirun``, ``save_config`` / ``load_yaml``, the YAML tree, and the
resolved flagship preset that ``chip_smoke.py`` trains with."""

import json
import sys
from pathlib import Path

import pytest
import yaml

from mipheivit_tpu_torch import config as port_config

REPO = Path(__file__).resolve().parent.parent

OVERRIDE_LISTS = [
    ["+default_configs=miphei-vit"],
    ["+default_configs=unetr"],
    ["+default_configs=miphei-vit", "data=hemit", "++train.epochs=3", "train.batch_size=4",
     "+experiments/gan=full_gan", "++model.encoder.encoder_weights=/w/enc.safetensors",
     "++data.targ_channel_names=[CD31,CD3e]", "train.losses.lambda_factor=2.5e-1"],
    ["+default_configs=convnext", "+experiments/finetuning=lora", "model=unet",
     "++train.callbacks.modelcheckpoint.monitor=val_gen_loss_sim"],
    [],
]


@pytest.mark.parametrize("overrides", OVERRIDE_LISTS, ids=lambda o: " ".join(o) or "root")
def test_compose_matches_jax(overrides):
    from mipheivit_tpu.config import compose as jax_compose

    got = port_config.compose(overrides)
    assert isinstance(got, port_config.Config) and isinstance(got.train, port_config.Config)
    assert got.to_dict() == jax_compose(overrides).to_dict()


@pytest.mark.parametrize("overrides", [
    ["+experiments/foundation_models=glob(*)", "++train.epochs=1"],
    ["+default_configs=miphei-vit", "train.seed=0,1,2", "+experiments/gan=glob(*_gan)"],
    ["+default_configs=miphei-vit"],
])
def test_compose_multirun_matches_jax(overrides):
    from mipheivit_tpu.config import compose_multirun as jax_multirun

    got, want = port_config.compose_multirun(overrides), jax_multirun(overrides)
    assert [name for name, _ in got] == [name for name, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.to_dict() == w.to_dict()


def test_malformed_override_and_missing_group_raise():
    with pytest.raises(ValueError, match="Malformed"):
        port_config.compose(["+default_configs"])
    with pytest.raises(FileNotFoundError):
        port_config.compose(["+default_configs=nope"])


def test_save_config_round_trips_through_yaml(tmp_path):
    """``save_config`` writes YAML without PyYAML; ``yaml.safe_load`` and the
    JAX package's ``load_yaml`` read back the same tree, edge values too."""
    from mipheivit_tpu.config import load_yaml as jax_load_yaml

    cfg = port_config.compose(["+default_configs=miphei-vit"])
    cfg.set_dotted("extra", {"tiny": 1e-7, "huge": 1e20, "neg": -0.5, "inf": float("inf"),
                             "words": ["yes", "no", "null", "on", "1.5", "a: b", "#c", ""],
                             "on": True, "1": None, "nested": [{"a": [1, 2]}, []],
                             "empty": {}, "quote": 'say "hi"\n'})
    path = tmp_path / "config.yaml"
    port_config.save_config(cfg, path)
    assert yaml.safe_load(path.read_text()) == cfg.to_dict()
    assert port_config.load_yaml(path) == cfg
    assert jax_load_yaml(path).to_dict() == cfg.to_dict()
    with pytest.raises(TypeError):
        port_config.Config.create({"bad": object()}).to_yaml()


def test_config_tree_is_the_jax_packages_byte_for_byte():
    ours, theirs = REPO / "mipheivit_tpu_torch" / "configs", REPO / "mipheivit_tpu" / "configs"
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*.yaml"))
    assert len(files) == 25
    assert sorted(p.relative_to(ours) for p in ours.rglob("*.yaml")) == files
    for rel in files:
        assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel


def test_chip_smoke_trainer_config_is_the_composed_preset(tmp_path):
    """``chip_smoke.py`` trains with the flagship preset as a dict (the card
    has no PyYAML): it equals the port's ``compose`` of the preset with the
    same overrides."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert chip_smoke.FLAGSHIP_PRESET == port_config.compose(
        ["+default_configs=miphei-vit"]).to_dict()
    data = {f"data.{s}_dataframe_path": str(tmp_path / f"{s}.csv")
            for s in ("train", "val", "test")}
    data["data.channel_stats_path"] = str(tmp_path / "channel_stats.json")
    for epochs in (1, 2):
        overrides = chip_smoke.trainer_overrides(data, tmp_path / "ckpt",
                                                 tmp_path / "hoptimus0.safetensors", epochs)
        want = port_config.compose(["+default_configs=miphei-vit"] +
                                   [f"++{k}={json.dumps(v)}" for k, v in overrides.items()])
        assert chip_smoke.trainer_config(overrides) == want
        assert want.train.epochs == epochs and want.data.slide_dataframe_path is None
