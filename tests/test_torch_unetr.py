"""The port's UNETR family (``models/unetr.py``) against the JAX package's.

The tapped blocks at every depth, a tiny ``UnetrViT`` (patch 16, and patch
14 with its nearest re-grid; LoRA rank 2) in eval, a reference-layout
checkpoint (written by the inverse of ``unetr_from_torch``, as
``tests/test_unetr_import.py`` writes it) loaded strictly into the port and
through the JAX importer, the committed ``parity_unetr_geom.npz`` through
the port's ``load_generator``, and the encoders the port refuses as the JAX
package does. f32 on the CPU, where attention and K2 run their plain
versions.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models import get_generator
from mipheivit_tpu_torch.models.convert import unetr_state_dict_from_jax
from mipheivit_tpu_torch.models.unetr import UnetrViT, extract_layers_for_depth
from mipheivit_tpu_torch.models.vit import ViTConfig
from torch_family_helpers import apply_jax, close, init_jax, load

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

# generator outputs: tanh maps, the UNETR fixture's own tolerance
GEN_TOL = 5e-4


def _cfgs(patch, lora_rank=2, img=64):
    from mipheivit_tpu.models.vit import ViTConfig as JC

    kw = dict(img_size=(img, img), patch_size=patch, embed_dim=64, depth=4, num_heads=1,
              mlp_hidden_dim=128, reg_tokens=4, lora_rank=lora_rank)
    return JC(attn_impl="xla", remat=False, **kw), ViTConfig(**kw)


def _jax_unetr(jcfg, x, seed=0):
    """A JAX ``UnetrViT`` and its seeded variables, LoRA B non-zero."""
    from mipheivit_tpu.models.unetr import UnetrViT as JU

    model = JU(vit_cfg=jcfg, out_chans=2)
    v = init_jax(model, x, seed, train=False)
    blocks = v["params"]["encoder_vit"]["blocks"]
    g = np.random.default_rng(seed + 7)
    if jcfg.lora_rank:
        for lq in ("lora_q", "lora_v"):
            b = blocks["attn"][lq]["B"]
            blocks["attn"][lq]["B"] = (g.standard_normal(b.shape) * 0.05).astype(np.float32)
    return model, v


def test_extract_layers_for_depth_matches_jax():
    from mipheivit_tpu.models.unetr import extract_layers_for_depth as jax_layers

    for depth in range(4, 41):
        assert extract_layers_for_depth(depth) == jax_layers(depth), depth
    assert extract_layers_for_depth(40) == (10, 20, 29, 39)
    assert extract_layers_for_depth(24) == (6, 12, 17, 23)     # univ2, phikonv2
    for depth in (1, 3):
        with pytest.raises(ValueError):
            extract_layers_for_depth(depth)


@pytest.mark.parametrize("patch", [16, 14])
def test_unetr_vit_matches_jax(patch):
    """Eval forward from the same weights: patch 16 at 64 px (no re-grid)
    and patch 14 at 112 px (the 8 x 8 grid re-gridded by nearest neighbour
    onto the 7 x 7 of stride 16; at 64 px it would be 4 x 4 onto 4 x 4)."""
    img = 64 if patch == 16 else 112
    jcfg, pcfg = _cfgs(patch, img=img)
    x = np.random.default_rng(1).standard_normal((2, img, img, 3)).astype(np.float32)
    jmodel, v = _jax_unetr(jcfg, x)
    want = np.asarray(apply_jax(jmodel, v, x, train=False))
    model = load(UnetrViT(pcfg, out_chans=2), unetr_state_dict_from_jax(v, pcfg)).eval()
    if patch == 14:
        assert pcfg.grid_size == (8, 8)    # re-gridded onto 7 x 7
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert 0.3 < np.abs(want).max() < 0.999
    close(got, want, GEN_TOL)


# the inverse of ``unetr_from_torch``, as tests/test_unetr_import.py writes
# it (copied: a test module is not imported)
def _inv_conv(k):
    return np.asarray(k).transpose(3, 2, 0, 1)


def _inv_convT(k):
    return np.asarray(k).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _emit_conv_block(sd, base, p, s):
    sd[f"{base}.block.0.weight"] = _inv_conv(p["conv"]["kernel"])
    sd[f"{base}.block.0.bias"] = np.asarray(p["conv"]["bias"])
    sd[f"{base}.block.1.weight"] = np.asarray(p["bn"]["scale"])
    sd[f"{base}.block.1.bias"] = np.asarray(p["bn"]["bias"])
    sd[f"{base}.block.1.running_mean"] = np.asarray(s["bn"]["mean"])
    sd[f"{base}.block.1.running_var"] = np.asarray(s["bn"]["var"])


def _emit_deconv_block(sd, base, p, s):
    sd[f"{base}.block.0.weight"] = _inv_convT(p["deconv"]["kernel"])
    sd[f"{base}.block.0.bias"] = np.asarray(p["deconv"]["bias"])
    sd[f"{base}.block.1.weight"] = _inv_conv(p["conv"]["kernel"])
    sd[f"{base}.block.1.bias"] = np.asarray(p["conv"]["bias"])
    sd[f"{base}.block.2.weight"] = np.asarray(p["bn"]["scale"])
    sd[f"{base}.block.2.bias"] = np.asarray(p["bn"]["bias"])
    sd[f"{base}.block.2.running_mean"] = np.asarray(s["bn"]["mean"])
    sd[f"{base}.block.2.running_var"] = np.asarray(s["bn"]["var"])


def _emit_unetr_state(params, stats, cfg, out_chans):
    from mipheivit_tpu.train.checkpoints import vit_state_dict

    sd = dict(vit_state_dict(params["encoder_vit"], cfg, "encoder.model.", wrap_qkv_lora=True))
    fu = "encoder.feature_upsampler"
    for i in range(2):
        _emit_conv_block(sd, f"{fu}.convsteam.{i}", params["feature_upsampler"][f"convsteam_{i}"],
                         stats["feature_upsampler"][f"convsteam_{i}"])
    for j, n_deconv in ((0, 3), (1, 2), (2, 1)):
        for d in range(n_deconv):
            _emit_deconv_block(sd, f"{fu}.upsampler{j}.{d + 1}",
                               params["feature_upsampler"][f"upsampler{j}_{d}"],
                               stats["feature_upsampler"][f"upsampler{j}_{d}"])
    dp, ds = params["decoder"], stats["decoder"]
    sd["decoder.bottleneck_upsampler.weight"] = _inv_convT(dp["bottleneck_upsampler"]["kernel"])
    sd["decoder.bottleneck_upsampler.bias"] = dp["bottleneck_upsampler"]["bias"]
    for stage, n_blocks in (("decoder3", 3), ("decoder2", 2), ("decoder1", 2)):
        for b in range(n_blocks):
            _emit_conv_block(sd, f"decoder.{stage}_upsampler.{b}", dp[f"{stage}_{b}"],
                             ds[f"{stage}_{b}"])
        sd[f"decoder.{stage}_upsampler.{n_blocks}.weight"] = _inv_convT(dp[f"{stage}_up"]["kernel"])
        sd[f"decoder.{stage}_upsampler.{n_blocks}.bias"] = dp[f"{stage}_up"]["bias"]
    for b in range(2):
        _emit_conv_block(sd, f"decoder.decoder0_header.{b}", dp[f"decoder0_{b}"],
                         ds[f"decoder0_{b}"])
    sd["decoder.decoder0_header.2.weight"] = _inv_conv(dp["decoder0_out"]["kernel"])
    sd["decoder.decoder0_header.2.bias"] = dp["decoder0_out"]["bias"]
    for k in range(out_chans):
        hp, hs = params[f"segmentation_head_{k}"], stats[f"segmentation_head_{k}"]
        base = f"segmentation_head_{k}"
        sd[f"{base}.0.psi.0.weight"] = _inv_conv(hp["attention"]["psi_conv1"]["kernel"])
        sd[f"{base}.0.psi.0.bias"] = hp["attention"]["psi_conv1"]["bias"]
        sd[f"{base}.0.psi.1.weight"] = hp["attention"]["psi_bn"]["scale"]
        sd[f"{base}.0.psi.1.bias"] = hp["attention"]["psi_bn"]["bias"]
        sd[f"{base}.0.psi.1.running_mean"] = hs["attention"]["psi_bn"]["mean"]
        sd[f"{base}.0.psi.1.running_var"] = hs["attention"]["psi_bn"]["var"]
        sd[f"{base}.0.psi.3.weight"] = _inv_conv(hp["attention"]["psi_conv2"]["kernel"])
        sd[f"{base}.0.psi.3.bias"] = hp["attention"]["psi_conv2"]["bias"]
        sd[f"{base}.1.weight"] = _inv_conv(hp["conv"]["kernel"])
        sd[f"{base}.1.bias"] = hp["conv"]["bias"]
    return sd


def test_reference_layout_loads_strictly_and_matches_jax_import():
    """The reference checkpoint's keys are the port's own, one for one
    (strict load, no key left over); the port's forward on it matches the
    JAX forward on ``unetr_from_torch`` of the same file, and
    ``models.convert`` gives the same tensors."""
    from mipheivit_tpu.models.import_weights import unetr_from_torch

    jcfg, pcfg = _cfgs(16)
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    jmodel, v = _jax_unetr(jcfg, x, seed=3)
    sd = _emit_unetr_state(v["params"], v["batch_stats"], jcfg, 2)
    model = UnetrViT(pcfg, out_chans=2)
    result = model.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
                                   strict=False)
    assert not result.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    assert set(sd) == {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    mapped = unetr_state_dict_from_jax(v, pcfg)
    for name, value in sd.items():
        np.testing.assert_array_equal(mapped[name], value, err_msg=name)
    params, stats = unetr_from_torch(sd, jcfg, out_chans=2)
    want = np.asarray(apply_jax(jmodel, {"params": params, "batch_stats": stats}, x,
                                train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    close(got, want, GEN_TOL)


def test_golden_fixture_through_load_generator(tmp_path, monkeypatch):
    """``parity_unetr_geom.npz`` (the torch oracle's output on its seeded
    checkpoint: patch 14, depth 40, the nearest re-grid, the 312 bottleneck,
    16 heads) through ``load_generator(device="cpu")``, foundation-stripped
    with the encoder file grafted back, as ``test_model_parity.py`` holds the
    JAX package to it."""
    from mipheivit_tpu_torch.infer.loading import load_generator
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.models import foundation

    sys.path.insert(0, str(REPO / "scripts"))
    from make_parity_fixtures import synth_input, synth_state_dict

    z = np.load(REPO / "tests/fixtures/parity_unetr_geom.npz")
    meta = json.loads(str(z["meta"]))
    state = synth_state_dict([(k, tuple(s)) for k, s in meta["keys_shapes"]])
    enc = {k[len("encoder.model."):]: a for k, a in state.items()
           if k.startswith("encoder.model.")}
    gen = {k: a for k, a in state.items() if not k.startswith("encoder.model.")}
    (tmp_path / "ckpt").mkdir()
    save_file(gen, tmp_path / "ckpt" / "model.safetensors")
    save_file(enc, tmp_path / "enc.safetensors")
    # the fixture's ViT: the flagship geometry at width 128, 2 heads of 64
    monkeypatch.setitem(foundation._VIT_SPECS, "hoptimus0", (dict(
        patch_size=14, embed_dim=128, depth=40, num_heads=2, mlp_hidden_dim=256,
        mlp_type="swiglu", init_values=1e-5, reg_tokens=4, no_embed_class=True), "fixture"))
    model = load_generator("unet", "hoptimus0", tmp_path / "ckpt", (256, 256), 16,
                           device="cpu", encoder_ckpt_path=str(tmp_path / "enc.safetensors"))
    assert isinstance(model, UnetrViT) and not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(synth_input())).numpy()
    np.testing.assert_allclose(got, z["out"], atol=meta["tol"]["out"], rtol=0)


def test_unported_and_unknown_encoders_raise_as_in_jax():
    """``unet`` on ``resnet50`` (experiments/models/resnet.yaml) is a
    ``KeyError`` in both packages; the Swin encoder and HEMIT are not
    ported and say where they are queued."""
    from mipheivit_tpu.models import get_generator as jax_get_generator
    from mipheivit_tpu.models.foundation import get_encoder_spec as jax_spec

    with pytest.raises(KeyError):
        jax_spec("resnet50", 256)
    with pytest.raises(KeyError):
        get_generator("unet", 256, 16, "resnet50", device="meta")
    with pytest.raises(NotImplementedError, match="item 15"):
        get_generator("unet_lora", 256, 16, "ctranspath", device="meta")
    with pytest.raises(NotImplementedError, match="item 15"):
        get_generator("hemit", 256, 16, device="meta")
    with pytest.raises(NotImplementedError):
        get_generator("cellvit", 256, 16, device="meta")
    assert type(jax_get_generator("unet", 256, 3, 16)).__name__ == "UnetrViT"


# built on the CPU with their initialisers run: every preset of the
# encoders up to ViT-L, and unet_lora on the ViT-g (hoptimus0,
# provgigapath) and ViT-H (univ2) encoders (~14 s and 4.8 GB each); their
# unet_frozen and unet builds, which differ only by the LoRA adapters, on
# the meta device (shapes only)
SMALL_ENCODERS = ("phikonv2", "sp85m", "restnet50_lunit_swav")


def _assert_decoder_initialised(model):
    """pix2pix_init ran: decoder convs N(0, 0.02), BatchNorm scales N(1, 0.02)."""
    conv = model.decoder.decoder0_header[0].block[0].weight
    bn = model.decoder.decoder0_header[0].block[1].weight
    assert abs(conv.std().item() - 0.02) < 2e-3
    assert abs(bn.mean().item() - 1.0) < 0.02 and abs(bn.std().item() - 0.02) < 8e-3
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("model_name,encoder_name", [
    *[(m, e) for m in ("unet_lora", "unet_frozen", "unet")
      for e in ("hoptimus0", "univ2", "provgigapath", "phikonv2", "sp85m")],
    ("unet", "restnet50_lunit_swav")])
def test_get_generator_builds_every_preset_at_full_width(model_name, encoder_name):
    """Full width and depth: on the CPU (see ``SMALL_ENCODERS``; the
    initialisers' statistics checked, and one 256-px tile through the
    ``unet`` builds) or on the meta device. LoRA rank 8 exactly where the
    name says ``lora``, the JAX builder's plan of channels."""
    cpu = encoder_name in SMALL_ENCODERS or model_name == "unet_lora"
    device = "cpu" if cpu else "meta"
    model = get_generator(model_name, 256, 16, encoder_name, device=device)
    names = set(model.state_dict())
    if device == "cpu":
        _assert_decoder_initialised(model)
        if model_name == "unet":
            x = torch.from_numpy(np.random.default_rng(0).uniform(
                -1, 1, (1, 256, 256, 3)).astype(np.float32))
            with torch.no_grad():
                out = model(x)
            assert out.shape == (1, 256, 256, 16) and torch.isfinite(out).all()
    if encoder_name == "restnet50_lunit_swav":
        assert type(model).__name__ == "UnetResnet50"
        assert "encoder.model.layer3.5.conv3.weight" in names
        assert not any(n.startswith("encoder.model.layer4") for n in names)
        return
    assert isinstance(model, UnetrViT)
    lora = any(".lora_q." in n for n in names)
    assert lora == ("lora" in model_name)
    assert model.encoder.feature_upsampler.channels[3] == 512
    assert model.vit_cfg.depth == {"univ2": 24, "phikonv2": 24, "sp85m": 12}.get(encoder_name, 40)
