"""The port's SMP U-Net (``models/smp_unet.py``) against the JAX package's.

A tiny ConvNeXt (dims 8/16/24/32, depths 1/1/2/1) and the ResNet-50 trunk
under a narrow decoder (16/8/8/8/8), with and without the foreground head,
in eval from the same seeded weights on the same numpy input; and the
checkpoint layout that ``smp_unet_from_torch`` reads (written by the inverse
of ``tests/test_smp_import.py``, copied here) loading into the port key for
key. f32 on the CPU.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models import get_generator
from mipheivit_tpu_torch.models.convert import smp_unet_state_dict_from_jax
from mipheivit_tpu_torch.models.smp_unet import UnetMultiHeads
from torch_family_helpers import apply_jax, close, init_jax, load

torch.set_num_threads(2)

GEN_TOL = 5e-4          # generator outputs (tanh masks and the fg logits)
DIMS, DEPTHS = (8, 16, 24, 32), (1, 1, 2, 1)
DECODER = (16, 8, 8, 8, 8)


def _models(encoder, fg):
    from mipheivit_tpu.models.smp_unet import UnetMultiHeads as JU

    kw = dict(encoder_name=encoder, out_chans=2, decoder_channels=DECODER, foreground_head=fg)
    if "convnext" in encoder:
        kw.update(encoder_dims=DIMS, encoder_depths=DEPTHS)
    return JU(**kw), UnetMultiHeads(**kw)


@pytest.mark.parametrize("encoder", ["tu-convnext_large", "resnet50"])
@pytest.mark.parametrize("fg", [False, True])
def test_unet_multi_heads_matches_jax(encoder, fg):
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel, model = _models(encoder, fg)
    v = init_jax(jmodel, x, train=False)
    want = apply_jax(jmodel, v, x, train=False)
    load(model, smp_unet_state_dict_from_jax(v)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if fg:
        (got, got_fg), (want, want_fg) = got, want
        assert got_fg.shape == (2, 64, 64, 2)
        assert np.abs(np.asarray(want_fg)).max() > 0.3     # live logits
        close(got_fg.numpy(), want_fg, GEN_TOL)
    assert 0.1 < np.abs(np.asarray(want)).max() < 0.999      # the heads live, not saturated
    close(got.numpy(), want, GEN_TOL)


# the inverse of ``smp_unet_from_torch``, as tests/test_smp_import.py writes
# it (copied: a test module is not imported)
def _inv_conv(k):
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _emit_conv(sd, base, p, bias=True):
    sd[f"{base}.weight"] = _inv_conv(p["kernel"])
    if bias and "bias" in p:
        sd[f"{base}.bias"] = np.asarray(p["bias"])


def _emit_ln(sd, base, p):
    sd[f"{base}.weight"] = np.asarray(p["scale"])
    sd[f"{base}.bias"] = np.asarray(p["bias"])


def _emit_bn(sd, base, p, s):
    _emit_ln(sd, base, p)
    sd[f"{base}.running_mean"] = np.asarray(s["mean"])
    sd[f"{base}.running_var"] = np.asarray(s["var"])


def _emit_dense(sd, base, p):
    sd[f"{base}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    sd[f"{base}.bias"] = np.asarray(p["bias"])


def _emit_smp_state(params, stats, out_chans, fg=False):
    sd = {}
    enc = params["encoder"]
    _emit_conv(sd, "encoder.model.stem.0", enc["stem_conv"])
    _emit_ln(sd, "encoder.model.stem.1", enc["stem_norm"])
    for s in range(4):
        sp = f"encoder.model.stages_{s}"
        if s > 0:
            _emit_ln(sd, f"{sp}.downsample.0", enc[f"down{s}_norm"])
            _emit_conv(sd, f"{sp}.downsample.1", enc[f"down{s}_conv"])
        for b in range(DEPTHS[s]):
            blk = enc[f"stage{s}_{b}"]
            bp = f"{sp}.blocks.{b}"
            _emit_conv(sd, f"{bp}.conv_dw", blk["dwconv"])
            _emit_ln(sd, f"{bp}.norm", blk["norm"])
            _emit_dense(sd, f"{bp}.mlp.fc1", blk["pwconv1"])
            _emit_dense(sd, f"{bp}.mlp.fc2", blk["pwconv2"])
            sd[f"{bp}.gamma"] = np.asarray(blk["gamma"])
    for i in range(5):
        base = f"decoder.blocks.{i}"
        blk, bst = params[f"decoder_block_{i}"], stats[f"decoder_block_{i}"]
        for name in ("conv1", "conv2"):
            _emit_conv(sd, f"{base}.{name}.0", blk[name]["conv"], bias=False)
            _emit_bn(sd, f"{base}.{name}.1", blk[name]["bn"], bst[name]["bn"])
    heads = [f"segmentation_head_{k}" for k in range(out_chans)] + (["foreground_head"] if fg
                                                                     else [])
    for name in heads:
        hp = params[name]
        if "attention" in hp:
            att = hp["attention"]
            _emit_conv(sd, f"{name}.0.psi.0", att["psi_conv1"])
            _emit_bn(sd, f"{name}.0.psi.1", att["psi_bn"], stats[name]["attention"]["psi_bn"])
            _emit_conv(sd, f"{name}.0.psi.3", att["psi_conv2"])
        _emit_conv(sd, f"{name}.1", hp["conv"])
    return sd


@pytest.mark.parametrize("fg", [False, True])
def test_emitted_smp_layout_loads_key_for_key(fg):
    """Every key of the layout ``smp_unet_from_torch`` reads is a key of the
    port's module (strict but for the BatchNorm counters), and
    ``models.convert`` writes the same tensors under the same names."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmodel, model = _models("tu-convnext_large", fg)
    v = init_jax(jmodel, x, train=False)
    sd = _emit_smp_state(v["params"], v["batch_stats"], 2, fg)
    result = model.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()}, strict=False)
    assert not result.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    mapped = smp_unet_state_dict_from_jax(v)
    assert {k for k in mapped if not k.endswith("num_batches_tracked")} == set(sd)
    for name, value in sd.items():
        np.testing.assert_array_equal(mapped[name], value, err_msg=name)


@pytest.mark.parametrize("encoder", ["tu-convnext_large", "resnet50"])
@pytest.mark.parametrize("fg", [False, True])
def test_get_generator_builds_smp_unet_at_full_width(encoder, fg):
    """The presets' SMP U-Nets at full width on the CPU, with the
    initialisers run (decoder and heads N(0, 0.02), ConvNeXt layer scale
    1e-6), the foreground head exactly when asked, and one 256-px tile
    through the ResNet-50 build."""
    model = get_generator("smp_unet", 256, 16, encoder, device="cpu", foreground_head=fg)
    names = set(model.state_dict())
    assert ("foreground_head.1.weight" in names) == fg
    if fg:
        assert model.foreground_head[1].weight.shape == (16, 16, 3, 3)
        assert abs(model.foreground_head[1].weight.std().item() - 0.02) < 2e-3
    if encoder == "resnet50":
        assert "encoder.layer4.2.conv3.weight" in names
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (1, 256, 256, 3)).astype(np.float32))
        with torch.no_grad():
            out = model(x)
        masks = out[0] if fg else out
        assert masks.shape == (1, 256, 256, 16) and torch.isfinite(masks).all()
        if fg:
            assert out[1].shape == (1, 256, 256, 16) and torch.isfinite(out[1]).all()
    else:
        block = model.encoder.model.stages_2.blocks[26]
        assert block.mlp.fc1.weight.shape == (3072, 768)
        assert torch.allclose(block.gamma, torch.full_like(block.gamma, 1e-6))
    conv = model.decoder.blocks[4].conv2[0].weight
    assert conv.shape == (16, 16, 3, 3)
    assert abs(conv.std().item() - 0.02) < 2e-3
    assert all(torch.isfinite(p).all() for p in model.parameters())
