"""The port's Swin (``models/swin.py``), the ctranspath UNETR and the Swin
importers against the JAX package's, on the CPU in f32.

The bias index and the shift mask, a tiny ``SwinTransformer`` on a 24 x 24
grid with window 5 (stages 0-2 pad and shift, stage 3's grid of 3 takes a
window of 3) in both collect modes, with and without ctranspath's conv stem
and LoRA, a tiny ``UnetrSwin`` and the full-width ctranspath presets, and a
timm / ctranspath-layout state dict (the inverse of the JAX importer, as
``tests/test_swin_import.py`` writes it) through the port's key map against
the JAX importer and model. Weights are seeded JAX variables carried across
by ``models.convert``.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.infer.loading import load_strict
from mipheivit_tpu_torch.models import get_generator
from mipheivit_tpu_torch.models.convert import (swin_state_dict_from_jax,
                                                unetr_swin_state_dict_from_jax)
from mipheivit_tpu_torch.models.import_hemit import (adapt_checkpoint_ctranspath,
                                                     resize_rel_pos_bias_table,
                                                     swin_state_dict_from_timm)
from mipheivit_tpu_torch.models.swin import (SwinConfig, SwinTransformer, _rel_pos_index,
                                             _shift_attn_mask)
from mipheivit_tpu_torch.models.unetr import UnetrSwin
from test_swin_import import _emit_timm_state
from torch_family_helpers import apply_jax, close, init_jax, load

torch.set_num_threads(2)

FEAT_TOL, GEN_TOL = 2e-4, 5e-4      # scripts/make_parity_fixtures.py TOL
IMG = 96


def _cfgs(conv_stem=False, lora_rank=0, img=IMG, window=5, embed=16):
    from mipheivit_tpu.models.swin import SwinConfig as JC

    kw = dict(img_size=(img, img), patch_size=4, embed_dim=embed, depths=(2, 2, 2, 2),
              num_heads=(1, 2, 2, 4), window_size=window, conv_stem=conv_stem,
              lora_rank=lora_rank)
    return JC(**kw), SwinConfig(**kw)


def _lora_b(params, seed):
    """Non-zero LoRA B in every block (B starts at 0)."""
    g = np.random.default_rng(seed)
    for name, blk in params.items():
        for lq in ("lora_q", "lora_v"):
            if name.startswith("layers") and lq in blk["attn"]:
                b = blk["attn"][lq]["B"]
                blk["attn"][lq]["B"] = (g.standard_normal(b.shape) * 0.05).astype(np.float32)


def _jax_swin(jcfg, x, seed=0):
    from mipheivit_tpu.models.swin import SwinTransformer as JS

    model = JS(jcfg)
    v = init_jax(model, x, seed)
    _lora_b(v["params"], seed + 5)
    return model, v


def test_rel_pos_index_and_shift_mask_match_jax():
    from mipheivit_tpu.models import swin as js

    for window in range(1, 10):
        np.testing.assert_array_equal(_rel_pos_index(window), js._rel_pos_index(window))
    for hp, wp, win, shift in ((70, 70, 7, 3), (14, 14, 7, 3), (25, 15, 5, 2), (16, 16, 8, 4)):
        np.testing.assert_array_equal(_shift_attn_mask(hp, wp, win, shift),
                                      js._shift_attn_mask(hp, wp, win, shift))


@pytest.mark.parametrize("collect", ["stage_out", "post_downsample"])
@pytest.mark.parametrize("conv_stem,lora_rank", [(False, 0), (True, 0), (False, 2), (True, 2)])
def test_swin_matches_jax(collect, conv_stem, lora_rank):
    """Every tap (and the final-normed tokens for ``stage_out``)."""
    jcfg, pcfg = _cfgs(conv_stem, lora_rank)
    x = np.random.default_rng(1).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    jmodel, v = _jax_swin(jcfg, x)
    want_x, want_feats = apply_jax(jmodel, v, x, collect=collect)
    model = load(SwinTransformer(pcfg), swin_state_dict_from_jax(v, pcfg)).eval()
    assert [blk.grid_window for stage in model.layers for blk in stage.blocks] == [5] * 6 + [3] * 2
    with torch.no_grad():
        got_x, got_feats = model(torch.from_numpy(x).permute(0, 3, 1, 2), collect=collect)
    assert len(got_feats) == len(want_feats) == (4 if collect == "stage_out" else 3)
    for got, want in zip(got_feats, want_feats):
        close(got.numpy(), want, FEAT_TOL)
    if collect == "stage_out":
        close(got_x.numpy(), want_x, FEAT_TOL)
    else:
        assert got_x is None


def test_conv_stem_batchnorm_keeps_running_statistics_in_training():
    """ctranspath's stem normalises by its running statistics in training
    too (flax ``use_running_average=True``), and does not update them."""
    _, pcfg = _cfgs(conv_stem=True)
    model = SwinTransformer(pcfg)
    bn = model.patch_embed.proj[1]
    with torch.no_grad():
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 3, IMG, IMG)
    with torch.no_grad():
        want = model.eval()(x)[1][0]
        mean = bn.running_mean.clone()
        got = model.train()(x)[1][0]
    torch.testing.assert_close(got, want)
    assert torch.equal(bn.running_mean, mean)


def _jax_unetr_swin(jcfg, x, seed=0):
    from mipheivit_tpu.models.unetr import UnetrSwin as JU

    model = JU(swin_cfg=jcfg, out_chans=2)
    v = init_jax(model, x, seed, train=False)
    _lora_b(v["params"]["model"], seed + 5)
    return model, v


@pytest.mark.parametrize("conv_stem,lora_rank", [(True, 2), (False, 0)])
def test_unetr_swin_matches_jax(conv_stem, lora_rank):
    """Eval forward of a tiny ``UnetrSwin`` (the 312 bottleneck: its last
    stage is under 512 wide) at 64 px: grids 16, 8, 4, 2 with window 5."""
    jcfg, pcfg = _cfgs(conv_stem, lora_rank, img=64)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel, v = _jax_unetr_swin(jcfg, x)
    want = np.asarray(apply_jax(jmodel, v, x, train=False))
    model = load(UnetrSwin(pcfg, out_chans=2), unetr_swin_state_dict_from_jax(v, pcfg)).eval()
    assert model.encoder.feature_upsampler.channels == (64, 128, 256, 312, 128)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert 0.3 < np.abs(want).max() < 0.999
    close(got, want, GEN_TOL)


@pytest.mark.parametrize("model_name", ["unet_lora", "unet_frozen", "unet"])
def test_get_generator_builds_ctranspath_at_full_width(model_name):
    """``experiments/foundation_models/ctranspath.yaml`` and its siblings:
    Swin-tiny with the conv stem at 256 px (stage grids 64 .. 8, window 7),
    LoRA rank 8 exactly under ``unet_lora``, the JAX module's parameter
    count, one tile through the ``unet`` build."""
    import jax

    from mipheivit_tpu.models import get_generator as jax_get_generator
    from mipheivit_tpu.config import compose

    model = get_generator(model_name, 256, 16, "ctranspath", device="cpu")
    assert isinstance(model, UnetrSwin) and not model.training
    cfg = model.swin_cfg
    assert cfg.conv_stem and cfg.window_size == 7 and cfg.depths == (2, 2, 6, 2)
    assert (cfg.lora_rank == 8) == (model_name == "unet_lora")
    assert model.encoder.feature_upsampler.channels[3] == 512
    jcfg = compose([f"model.model_name={model_name}", "model.encoder.encoder_name=ctranspath"])
    jmodel = jax_get_generator(model_name, 256, 3, 16, jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                np.zeros((1, 256, 256, 3), np.float32)))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if model_name == "unet":
        x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 256, 256, 3))
                             .astype(np.float32))
        with torch.no_grad():
            out = model(x)
        assert out.shape == (1, 256, 256, 16) and torch.isfinite(out).all()


def test_ctranspath_key_adaptation_and_rel_pos_resize_match_jax():
    from mipheivit_tpu.models import import_weights as jw

    g = np.random.default_rng(3)
    state = {"layers.0.downsample.norm.weight": g.standard_normal(4),
             "layers.2.downsample.reduction.weight": g.standard_normal((4, 8)),
             "layers.1.blocks.0.attn.relative_position_index": np.zeros(4),
             "layers.1.blocks.1.attn_mask": np.zeros(4),
             "layers.1.blocks.0.norm1.weight": g.standard_normal(4)}
    got, want = adapt_checkpoint_ctranspath(state), jw.adapt_checkpoint_ctranspath(state)
    assert list(got) == list(want) == ["layers.1.downsample.norm.weight",
                                       "layers.3.downsample.reduction.weight",
                                       "layers.1.blocks.0.norm1.weight"]
    for old, new in ((7, 7), (7, 4), (7, 8), (12, 7), (5, 3)):
        table = g.standard_normal(((2 * old - 1) ** 2, 3)).astype(np.float32)
        ours = resize_rel_pos_bias_table(torch.from_numpy(table), new).numpy()
        np.testing.assert_allclose(ours, jw.resize_rel_pos_bias_table(table, new), rtol=0,
                                   atol=1e-6, err_msg=f"{old} -> {new}")


def _to_old_timm(sd):
    """The newer timm layout back to ctranspath's: each stage's downsample at
    the end of the stage before, with the index and mask buffers."""
    out = {}
    for k, v in sd.items():
        if ".downsample." in k:
            parts = k.split(".")
            parts[1] = str(int(parts[1]) - 1)
            k = ".".join(parts)
        out[k] = v
        if k.endswith("relative_position_bias_table"):
            out[k.replace("relative_position_bias_table", "relative_position_index")] = np.zeros(1)
    return out


@pytest.mark.parametrize("conv_stem", [False, True])
def test_timm_layout_loads_strictly_and_matches_jax_import(conv_stem):
    """A Swin saved at window 7 (the ctranspath layout for the conv stem),
    loaded into a window-5 model: the tables resampled, the old layout's
    keys shifted; the port's forward matches JAX's ``swin_params_from_torch``
    + model on the same dict."""
    from mipheivit_tpu.models.import_weights import swin_params_from_torch
    from mipheivit_tpu.models.swin import SwinTransformer as JS

    jcfg7, _ = _cfgs(conv_stem, window=7)
    jcfg, pcfg = _cfgs(conv_stem, window=5)
    x = np.random.default_rng(4).standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    _, v = _jax_swin(jcfg7, x, seed=6)
    sd = _emit_timm_state(v["params"], v.get("batch_stats", {}), jcfg7)
    if conv_stem:
        sd = adapt_checkpoint_ctranspath(_to_old_timm(sd))
    params, stats = swin_params_from_torch(sd, jcfg)
    want_x, want = apply_jax(JS(jcfg), {"params": params, "batch_stats": stats}, x)
    model = load_strict(SwinTransformer(pcfg), swin_state_dict_from_timm(sd, pcfg)).eval()
    with torch.no_grad():
        got_x, got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for a, b in zip(got, want):
        close(a.numpy(), b, FEAT_TOL)
    close(got_x.numpy(), want_x, FEAT_TOL)
