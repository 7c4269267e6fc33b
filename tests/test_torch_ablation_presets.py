"""The paper's ablation presets in the port against the JAX package, on the CPU.

The five experiment files that ``chip_smoke.py`` trains on the card
(``gan/partial_gan``, ``gan/full_gan``, ``foundation_models/univ2``,
``finetuning/full_finetuning``, ``finetuning/frozen``): the port's
``compose`` of each against JAX's in the settings the smoke's phases read,
and the smoke's dict of each against the port's ``compose``; the UNETR's
eval forward on univ2, phikonv2 and sp85m at each encoder's own width,
heads, MLP and registers (4 blocks: the UNETR taps 4) against JAX's; the
structural discriminator's markers against the JAX trainer's. f32; the
port's attention and K2 run their plain versions.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_synthetic_run as syn
from torch_family_helpers import apply_jax, close, family_variables, load

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

EXPERIMENTS = ["gan=partial_gan", "gan=full_gan", "foundation_models=univ2",
               "finetuning=full_finetuning", "finetuning=frozen"]
# what the smoke's ablation phases read of a preset
PHASE_KEYS = ("model.model_name", "model.encoder.encoder_name", "train.batch_size",
              "train.gan_train", "train.gan_mode", "train.grad_accum_steps")
# the UNETR's generator output: scripts/make_parity_fixtures.py's TOL["out"]
GEN_TOL = 5e-4
# the UNETR needs 4 blocks (its taps); the input side each encoder's patch
# gives a re-grid at patch 14 (8 x 8 onto 7 x 7) and none at patch 16
CUT, IMG = 4, {"univ2": 112, "phikonv2": 64, "sp85m": 64}


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_chip_smoke_ablation_preset_is_the_composed_preset(experiment):
    """The port composes each ablation preset as the JAX package does in
    the settings the smoke's phases use, and ``chip_smoke.ABLATION_PRESETS``
    (a dict: the card has no PyYAML) is the port's composed tree."""
    from mipheivit_tpu.config import compose as jax_compose
    from mipheivit_tpu_torch.config import compose

    port = compose([f"+experiments/{experiment}"])
    want = jax_compose([f"+experiments/{experiment}"])
    assert {k: port.select(k) for k in PHASE_KEYS} == {k: want.select(k) for k in PHASE_KEYS}
    assert chip_smoke.ABLATION_PRESETS[experiment] == port.to_dict()


@pytest.fixture(scope="module", params=sorted(IMG))
def encoder_unetr(request):
    """(name, JAX ``UnetrViT``, its seeded variables, the port's config) of
    ``unet_lora`` on one encoder of each package's registry, cut to ``CUT``
    blocks at its own width, heads, MLP and registers."""
    from mipheivit_tpu.models.foundation import get_encoder_spec as jax_spec
    from mipheivit_tpu.models.unetr import UnetrViT as JU
    from mipheivit_tpu_torch.models.foundation import get_encoder_spec

    name, img = request.param, IMG[request.param]
    jcfg = jax_spec(name, img).vit_cfg.replace(lora_rank=8, lora_alpha=1.0, depth=CUT,
                                               attn_impl="xla", remat=False)
    pcfg = get_encoder_spec(name, img).vit_cfg.replace(lora_rank=8, lora_alpha=1.0, depth=CUT)
    jmodel = JU(vit_cfg=jcfg, out_chans=2)
    return name, jmodel, family_variables(jmodel, img=img), pcfg


def test_ablation_encoder_unetr_matches_jax(encoder_unetr):
    """The eval forward of ``unet_lora`` on univ2 (8 registers, SwiGLU),
    phikonv2 (16 heads, GELU) and sp85m (12 heads, GELU, eps 1e-6, no
    layerscale) from the same weights; the two registries agree on each
    encoder's geometry, and ``chip_smoke.ENCODER_GEOMETRY`` holds it at the
    smoke's 256 px."""
    from mipheivit_tpu.models.foundation import get_encoder_spec as jax_spec
    from mipheivit_tpu_torch.models.convert import unetr_state_dict_from_jax
    from mipheivit_tpu_torch.models.foundation import get_encoder_spec
    from mipheivit_tpu_torch.models.unetr import UnetrViT

    name, jmodel, v, pcfg = encoder_unetr
    # every field of the port's config but the attention route the JAX one's
    for f in dataclasses.fields(pcfg):
        if f.name != "attn_impl":
            assert getattr(pcfg, f.name) == getattr(jmodel.vit_cfg, f.name), f.name
    full, jfull = get_encoder_spec(name, 256).vit_cfg, jax_spec(name, 256).vit_cfg
    geometry = (full.num_prefix_tokens + full.num_patches, full.num_prefix_tokens,
                full.num_heads, full.mlp_type == "swiglu")
    assert geometry == (jfull.num_prefix_tokens + jfull.num_patches, jfull.num_prefix_tokens,
                        jfull.num_heads, jfull.mlp_type == "swiglu")
    assert chip_smoke.ENCODER_GEOMETRY[name] == geometry
    x = np.random.default_rng(1).standard_normal((2, IMG[name], IMG[name], 3)).astype(np.float32)
    want = np.asarray(apply_jax(jmodel, v, x, train=False))
    model = load(UnetrViT(pcfg, out_chans=2), unetr_state_dict_from_jax(v, pcfg)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # most outputs off tanh's saturation, where a difference would show
    assert np.abs(want).max() > 0.1 and np.mean(np.abs(want) < 0.99) > 0.5
    close(got, want, GEN_TOL)


@pytest.mark.parametrize("experiment", ["gan=partial_gan", "gan=full_gan"])
def test_discriminator_channels_match_the_jax_trainer(experiment, tmp_path, monkeypatch):
    """The markers the GAN ablation's discriminator sees for ORION's 16
    (``data/orion.yaml``) under the smoke's channel statistics: the port's
    ``trainer.discriminator_channels``, which ``train_patchgan`` and the
    smoke's [train gan …] phases use, gives the JAX trainer's choice (the
    structural ones in ``gan/partial_gan``, all in ``gan/full_gan``)."""
    import mipheivit_tpu.train.trainer as jax_trainer
    from mipheivit_tpu.config import compose as jax_compose
    from mipheivit_tpu_torch.data.stats import load_channel_stats
    from mipheivit_tpu_torch.train.trainer import discriminator_channels

    values = syn.write_run(tmp_path / "run")
    smoke = chip_smoke.write_trainer_data(tmp_path / "smoke", 0, img=32,
                                          tiles={"train": 1, "val": 1, "test": 1})
    values["data.channel_stats_path"] = smoke["data.channel_stats_path"]
    cfg = jax_compose([f"+experiments/{experiment}"])
    values.pop("data.targ_channel_names", None)    # ORION's 16, as the preset has them
    for key, value in {**values, "data.slide_dataframe_path": None}.items():
        cfg.set_dotted(key, value)
    names = list(cfg.data.targ_channel_names)
    assert names == chip_smoke.FLAGSHIP_PRESET["data"]["targ_channel_names"]

    class Built(Exception):
        pass

    def capture(**kw):
        raise Built(kw["selected_channels"])

    monkeypatch.setattr(jax_trainer, "DiscriminatorPatch", capture)
    with pytest.raises(Built) as built:
        jax_trainer.train_patchgan(cfg, str(tmp_path / "log"), use_wandb=False)
    want = built.value.args[0]
    got = discriminator_channels(cfg.train.gan_mode,
                                 load_channel_stats(values["data.channel_stats_path"]), names)
    assert got == want
    assert (got is None) == (experiment == "gan=full_gan")
    assert got is None or got == [0, 1]          # the smoke's Hoechst and CD31
