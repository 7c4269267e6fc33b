"""The port's CNN encoders (``models/cnn.py``) against the JAX package's.

``Bottleneck``, the full-width ``ResNet50`` at 64 px (eval, and training
mode's batch statistics with the running statistics after one step), a tiny
``ConvNeXtBlock`` / ``ConvNeXt`` (dims 8/16/24/32, depths 1/1/2/1) and the
ResNet-50 UNETR, each from the same seeded weights (the JAX variables mapped
by ``models.convert``, BatchNorm statistics and scales moved off their
init) on the same numpy inputs, in f32 on the CPU.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models import cnn
from mipheivit_tpu_torch.models.convert import _Emitter, unet_resnet50_state_dict_from_jax
from torch_family_helpers import apply_jax
from torch_family_helpers import close as _close
from torch_family_helpers import init_jax as _init
from torch_family_helpers import load as _load
from torch_family_helpers import nchw as _nchw

torch.set_num_threads(2)

# Blocks and trunks: the same f32 convolutions summed in another order, held
# relative to the output's largest magnitude (the full-width ResNet-50's
# eval output reaches ~1e2 on these weights).
BLOCK_TOL = 1e-4
# The generator: tanh outputs, as the UNETR family's parity fixture holds.
GEN_TOL = 5e-4
DIMS, DEPTHS = (8, 16, 24, 32), (1, 1, 2, 1)


def _resnet_state(params, stats):
    e = _Emitter()
    e.resnet("", params, stats)
    return e.out


@pytest.mark.parametrize("stride,downsample", [(1, False), (2, True)])
def test_bottleneck_matches_jax(stride, downsample):
    from mipheivit_tpu.models.cnn import Bottleneck as JB

    x = np.random.default_rng(0).standard_normal((2, 8, 8, 64)).astype(np.float32)
    jb = JB(16, stride, downsample)
    v = _init(jb, x, train=False)
    want = np.asarray(apply_jax(jb, v, x, train=False))
    state = _resnet_state({"layer1_0": v["params"]}, {"layer1_0": v["batch_stats"]})
    block = _load(cnn.Bottleneck(64, 16, stride, downsample), state, "layer1.0.").eval()
    with torch.no_grad():
        got = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_matches_jax(train):
    """Full widths at 64 px: the five stage features; in training mode the
    batch statistics normalise and every running statistic moves as flax's
    does (momentum 0.9, biased batch variance).

    Training mode runs in f64 on both sides: at 64 px layer3 and layer4 see
    32 and 8 values a channel, and normalising by their batch statistics
    amplifies f32 rounding ~1e3-fold (the port's f32 output is within 2e-4
    of its f64 one at layer4, JAX's within 6e-4), which would hide the
    arithmetic the test is after."""
    import jax

    from mipheivit_tpu.models.cnn import ResNet50 as JR

    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jr = JR(num_stages=4)
    v = _init(jr, x, train=False)
    model = _load(cnn.ResNet50(4), _resnet_state(v["params"], v["batch_stats"]))
    model.train(train)
    if train:
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
            want, mutated = apply_jax(jr, v64, x.astype(np.float64), train=True,
                                      mutable=["batch_stats"])
            want = [np.asarray(w) for w in want]
            mutated = jax.tree.map(np.asarray, mutated)
        model.double()
        with torch.no_grad():
            got = model(_nchw(x).double())
    else:
        want = apply_jax(jr, v, x, train=False)
        with torch.no_grad():
            got = model(_nchw(x))
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, BLOCK_TOL)
    if train:
        assert want[-1].dtype == np.float64
        new = _resnet_state({}, mutated["batch_stats"])
        for name, value in model.state_dict().items():
            if "running_" in name:
                np.testing.assert_allclose(value.numpy(), new[name], rtol=1e-5, atol=1e-5,
                                           err_msg=name)


def test_convnext_block_and_trunk_match_jax():
    from mipheivit_tpu.models.cnn import ConvNeXt as JC
    from mipheivit_tpu.models.cnn import ConvNeXtBlock as JCB

    g = np.random.default_rng(2)
    xb = g.standard_normal((2, 9, 9, 12)).astype(np.float32)
    jb = JCB(12)
    v = _init(jb, xb)
    e = _Emitter()
    e.convnext("", {"stage0_0": v["params"]})
    block = _load(cnn.ConvNeXtBlock(12), e.out, "stages_0.blocks.0.").eval()
    with torch.no_grad():
        got = block(_nchw(xb)).permute(0, 2, 3, 1).numpy()
    _close(got, apply_jax(jb, v, xb), BLOCK_TOL)

    x = g.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jc = JC(dims=DIMS, depths=DEPTHS)
    v = _init(jc, x, train=False)
    e = _Emitter()
    e.convnext("", v["params"])
    trunk = _load(cnn.ConvNeXt(DIMS, DEPTHS), e.out).eval()
    with torch.no_grad():
        got = trunk(_nchw(x))
    want = apply_jax(jc, v, x)
    assert [t.shape[1] for t in got] == list(DIMS)
    for a, b in zip(got, want):
        _close(a.permute(0, 2, 3, 1).numpy(), b, BLOCK_TOL)


def test_unet_resnet50_matches_jax():
    from mipheivit_tpu.models.cnn import UnetResnet50 as JU

    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ju = JU(out_chans=3)
    v = _init(ju, x, train=False)
    model = _load(cnn.UnetResnet50(out_chans=3), unet_resnet50_state_dict_from_jax(v)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(apply_jax(ju, v, x, train=False))
    assert 0.3 < np.abs(want).max() < 0.999       # the heads neither dead nor saturated
    _close(got, want, GEN_TOL)
