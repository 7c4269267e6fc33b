"""The port's HEMIT zoo (``models/hemit.py``) against the JAX package's, on
the CPU in f32.

The transposed convolutions with and without output padding, the gated
cross-attention (k below H*W and k clamped to it; the chosen index sets
equal), the tiny dual-branch generator, the pix2pix generators and both
discriminators in eval mode and in one training-mode forward (BatchNorm
statistics updated), and ``build_hemit_netG``'s dispatch at full width.
Weights are seeded JAX variables carried across by
``models.convert.hemit_state_dict_from_jax``.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models import get_generator
from mipheivit_tpu_torch.models import hemit as ph
from mipheivit_tpu_torch.models.convert import _convT, hemit_state_dict_from_jax
from mipheivit_tpu_torch.models.layers import ConvTranspose2d
from mipheivit_tpu_torch.models.swin import SwinConfig
from torch_family_helpers import apply_jax, close, init_jax, load

torch.set_num_threads(2)

GEN_TOL = 5e-4          # scripts/make_parity_fixtures.py TOL, generator outputs
STAT_ATOL, STAT_RTOL = 1e-5, 1e-5
IMG = 64
SWIN = dict(img_size=(IMG, IMG), patch_size=4, embed_dim=16, depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 8), window_size=4)


@pytest.mark.parametrize("k,s,p,op", [(3, 2, 1, 1), (4, 2, 1, 0), (2, 2, 0, 0)])
def test_conv_transpose_matches_jax(k, s, p, op):
    """``layers.ConvTranspose2d`` honours ``output_padding`` (the HEMIT
    decoders' k3 s2 p1 op1), against JAX's ``TorchConvTranspose``."""
    import jax.numpy as jnp

    from mipheivit_tpu.ops.deconv import TorchConvTranspose

    g = np.random.default_rng(k + op)
    x = g.standard_normal((2, 9, 11, 5)).astype(np.float32)
    kernel = g.standard_normal((k, k, 5, 7)).astype(np.float32)
    bias = g.standard_normal(7).astype(np.float32)
    want = np.asarray(TorchConvTranspose(7, (k, k), strides=(s, s), padding=p, output_padding=op)
                      .apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                             jnp.asarray(x)))
    conv = ConvTranspose2d(5, 7, k, stride=s, padding=p, output_padding=op)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(_convT(kernel)))
        conv.bias.copy_(torch.from_numpy(bias))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 9 * 2 - 2 * p + k - 2 + op, 11 * 2 - 2 * p + k - 2 + op, 7)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _swint_pair(top_k=100, norm="batch"):
    from mipheivit_tpu.models.hemit import ResnetGeneratorSwinT as JG
    from mipheivit_tpu.models.swin import SwinConfig as JC

    jm = JG(out_channels=3, ngf=8, n_blocks=2, norm=norm, swin_cfg=JC(**SWIN), top_k=top_k)
    pm = ph.ResnetGeneratorSwinT(3, IMG, ngf=8, n_blocks=2, norm=norm,
                                 swin_cfg=SwinConfig(**SWIN), top_k=top_k)
    return jm, pm


def _pair(name, norm):
    """(JAX module, port module, input channels) of a tiny zoo member."""
    from mipheivit_tpu.models import hemit as jh

    if name == "swint":
        return (*_swint_pair(norm=norm), 3)
    if name == "resnet":
        return (jh.ResnetGenerator(out_channels=3, ngf=8, n_blocks=2, norm=norm),
                ph.ResnetGenerator(3, ngf=8, n_blocks=2, norm=norm), 3)
    if name == "unet":
        return (jh.UnetGenerator(out_channels=3, num_downs=6, ngf=8, norm=norm),
                ph.UnetGenerator(3, num_downs=6, ngf=8, norm=norm), 3)
    if name == "nlayer":
        return (jh.NLayerDiscriminator(ndf=8, n_layers=3, norm=norm),
                ph.NLayerDiscriminator(6, ndf=8, n_layers=3, norm=norm), 6)
    return (jh.PixelDiscriminator(ndf=8, norm=norm), ph.PixelDiscriminator(6, ndf=8, norm=norm), 6)


def _variables(jm, x, seed=0):
    """Seeded variables; ``init_jax`` scales kernels named ``head`` up for
    the marker heads' N(0, 0.02) init, which saturates the ResNet
    generator's final conv: undone here."""
    v = init_jax(jm, x, seed, train=False)
    if "head" in v["params"]:
        v["params"]["head"]["kernel"] = v["params"]["head"]["kernel"] / np.float32(25.0)
    return v


@pytest.mark.parametrize("name,norm", [("swint", "batch"), ("resnet", "instance"),
                                       ("resnet", "batch"), ("unet", "batch"),
                                       ("unet", "instance"), ("nlayer", "instance"),
                                       ("nlayer", "batch"), ("pixel", "batch")])
def test_zoo_matches_jax_in_eval_and_train(name, norm):
    """Eval, then one training-mode forward from the same weights: the
    output and every BatchNorm's updated running statistics."""
    jm, pm, cin = _pair(name, norm)
    x = np.random.default_rng(1).standard_normal((2, IMG, IMG, cin)).astype(np.float32)
    v = _variables(jm, x)
    load(pm, hemit_state_dict_from_jax(v, pm))
    want = np.asarray(apply_jax(jm, v, x, train=False))
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    close(got, want, GEN_TOL)
    if name not in ("nlayer", "pixel"):
        assert 0.2 < np.abs(want).max() < 0.999

    want, upd = apply_jax(jm, v, x, train=True, mutable=["batch_stats"])
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    close(got, np.asarray(want), GEN_TOL)
    stats = hemit_state_dict_from_jax({"batch_stats": upd.get("batch_stats", {})}, pm)
    state = pm.state_dict()
    assert (len([k for k in stats if "running_" in k]) > 0) == (norm == "batch")
    for key, value in stats.items():
        if "running_" in key:
            np.testing.assert_allclose(state[key].numpy(), value, atol=STAT_ATOL,
                                       rtol=STAT_RTOL, err_msg=key)


@pytest.mark.parametrize("top_k", [100, 5000])
def test_gated_cross_attention_matches_jax(top_k):
    """Each of the three fusions on its own inputs (a CNN map and the Swin
    tap it reads), k = 100 of the 1024, 256 and 64 positions (clamped where
    fewer) and k = 5000 (clamped to all): the fused map, and the chosen
    positions as a set."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models.hemit import GatedCrossAttention as JGCA

    jm, pm = _swint_pair(top_k)
    x = np.zeros((2, IMG, IMG, 3), np.float32)
    v = _variables(jm, x, seed=2)
    load(pm, hemit_state_dict_from_jax(v, pm)).eval()
    g = np.random.default_rng(3)
    for i in range(3):
        c, hw = 8 * 2 ** (i + 1), IMG // 2 ** (i + 1)
        cnn = g.standard_normal((2, hw, hw, c)).astype(np.float32)
        swin = g.standard_normal((2, hw // 4, hw // 4, SWIN["embed_dim"] * 2 ** (i + 1))
                                 ).astype(np.float32)
        params = v["params"][f"cross_att{i}"]
        want = np.asarray(apply_jax(JGCA(c, k=top_k, upsample_factor=2),
                                    {"params": params}, cnn, swin_feat=swin))
        att = pm.cross_atts[i]
        with torch.no_grad():
            got = att(torch.from_numpy(cnn).permute(0, 3, 1, 2),
                      torch.from_numpy(swin).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        close(got, want, GEN_TOL)
        gate = (cnn.reshape(2, -1, c) @ np.asarray(params["gate"]["kernel"]).reshape(c, 1)
                + np.asarray(params["gate"]["bias"]))
        k = min(top_k, hw * hw)
        _, jidx = jax.lax.top_k(jax.nn.sigmoid(jnp.asarray(gate[..., 0])), k)
        assert att.last_indices.shape == (2, k)
        for b in range(2):
            assert set(att.last_indices[b].tolist()) == set(np.asarray(jidx[b]).tolist())
        assert (k < hw * hw) == (top_k == 100 and i < 2)      # 64 positions: clamped


def test_build_hemit_netG_dispatches_as_jax():
    """Every netG name at full width: the JAX builder's module class and
    parameter count (``jax.eval_shape``, nothing compiled); unknown names
    raise in both."""
    import jax

    from mipheivit_tpu.models.hemit import build_hemit_netG as jax_build

    for net in ph.NETG_NAMES:
        size = 1024 if net == "unet_1024" else 256
        jm = jax_build(net, size, 3, 3)
        pm = ph.build_hemit_netG(net, size, 3, 3)
        assert type(pm).__name__ == type(jm).__name__, net
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                np.zeros((1, size, size, 3), np.float32)))
        n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
        assert sum(p.numel() for p in pm.parameters()) == n_jax, net
    for build in (jax_build, ph.build_hemit_netG):
        with pytest.raises(NotImplementedError):
            build("pix2pixHD", 256, 3, 3)


def test_get_generator_builds_hemit_as_jax():
    """``model.model_name=hemit`` (``default_configs/hemit.yaml``): the
    dual-branch generator at 256 px with ngf 64, 6 blocks, batch norm and
    Swin-tiny (window 7: grids 64 .. 8 padded to 70 .. 14), one tile."""
    model = get_generator("hemit", 256, 16, device="cpu")
    assert isinstance(model, ph.ResnetGeneratorSwinT) and not model.training
    assert model.n_blocks == 6 and model.swin_cfg.window_size == 7
    assert [blk.grid_window for s in model.swinT.layers for blk in s.blocks] == [7] * 12
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 256, 256, 3))
                         .astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out.shape == (1, 256, 256, 16) and torch.isfinite(out).all()
    assert [att.last_indices.shape[1] for att in model.cross_atts] == [1000, 1000, 1000]
