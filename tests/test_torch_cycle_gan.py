"""The port's CycleGAN stain normaliser (``mipheivit_tpu_torch.preprocessings.
cycle_gan``) against the JAX package's (``preprocessings/cycle_gan``,
imported through ``sys.path``), on the CPU in f32, at ``ngf`` 8 and 2
ResNet blocks.

The generator's output is within ``GEN_TOL`` (absolute; it is a tanh) of
flax's, its weights taken by either route: a pix2pix ``model.N`` state
dict through both importers, or the flax params through
``convert.cycle_gan_state_dict_from_jax``. One upsampling layer alone equals
flax's ``nn.ConvTranspose(padding="SAME")`` within ``GEN_TOL``, while
pix2pix's ``ConvTranspose2d(3, 2, 1, output_padding=1)`` on the same weight
does not. The scripts (the tile CLI and the slide CLI, their generators
patched to the small width on both sides) write images within one uint8
step of the JAX scripts'.
"""

import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mipheivit_tpu_torch.models.convert import cycle_gan_state_dict_from_jax
from mipheivit_tpu_torch.preprocessings.cycle_gan import (
    cycle_gan_wsi_inference as pwsi, normalize_tiles as ptiles, resnet_generator as prg)
from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "preprocessings" / "cycle_gan"))

import cycle_gan_wsi_inference as jwsi  # noqa: E402
import normalize_tiles as jtiles  # noqa: E402
import resnet_generator as jrg  # noqa: E402

torch.set_num_threads(2)

NGF, BLOCKS = 8, 2
GEN_TOL = 1e-4


def pix2pix_state(ngf=NGF, n_blocks=BLOCKS, seed=0):
    """A seeded pix2pix ``ResnetGenerator`` state dict (``model.N`` keys,
    ConvTranspose weights ``[in, out, 3, 3]``), weights N(0, 0.15)."""
    g = np.random.default_rng(seed)
    shapes = {1: (ngf, 3, 7, 7), 4: (2 * ngf, ngf, 3, 3), 7: (4 * ngf, 2 * ngf, 3, 3)}
    for i in range(n_blocks):
        shapes[f"{10 + i}.conv_block.1"] = (4 * ngf, 4 * ngf, 3, 3)
        shapes[f"{10 + i}.conv_block.5"] = (4 * ngf, 4 * ngf, 3, 3)
    up0 = 10 + n_blocks
    shapes[up0] = (4 * ngf, 2 * ngf, 3, 3)
    shapes[up0 + 3] = (2 * ngf, ngf, 3, 3)
    shapes[up0 + 7] = (3, ngf, 7, 7)
    out = {}
    for key, shape in shapes.items():
        out[f"model.{key}.weight"] = (0.15 * g.standard_normal(shape)).astype(np.float32)
        bias = shape[1] if key in (up0, up0 + 3) else shape[0]
        out[f"model.{key}.bias"] = (0.05 * g.standard_normal(bias)).astype(np.float32)
    return out


def _flax(x, params):
    import jax.numpy as jnp

    return np.asarray(jrg.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS).apply(
        {"params": params}, jnp.asarray(x)))


def _port(x, state):
    model = prg.build_generator(state, NGF, BLOCKS, device="cpu")
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("route", ["pix2pix_state_dict", "flax_params"])
def test_generator_matches_flax(x, route):
    """ngf 8, 2 blocks on 64 x 64: within GEN_TOL of the flax generator."""
    import jax

    if route == "pix2pix_state_dict":
        sd = pix2pix_state()
        params = jrg.params_from_torch(sd, ngf=NGF, n_blocks=BLOCKS)
        state = prg.params_from_torch({k: torch.from_numpy(v) for k, v in sd.items()},
                                      ngf=NGF, n_blocks=BLOCKS)
    else:
        v = jax.eval_shape(jrg.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS).init,
                           jax.random.PRNGKey(0), x)
        g = np.random.default_rng(2)
        params = jax.tree.map(lambda a: (0.15 * g.standard_normal(a.shape)).astype(np.float32),
                              v["params"])
        state = cycle_gan_state_dict_from_jax(params)
    want, got = _flax(x, params), _port(x, state)
    assert got.shape == want.shape == (2, 64, 64, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= GEN_TOL


def test_upsample_is_flax_conv_transpose_not_pix2pix():
    """``FlaxConvTranspose2d`` equals flax's ``ConvTranspose(3, 2, "SAME")``
    on the importer's unflipped view of a ``[in, out, 3, 3]`` weight;
    pix2pix's ``ConvTranspose2d(3, 2, 1, output_padding=1)`` on the same
    weight is far off."""
    import flax.linen as nn
    import jax.numpy as jnp

    g = np.random.default_rng(3)
    w = (0.3 * g.standard_normal((6, 4, 3, 3))).astype(np.float32)
    b = (0.1 * g.standard_normal(4)).astype(np.float32)
    x = g.standard_normal((2, 9, 11, 6)).astype(np.float32)
    layer = nn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
    want = np.asarray(layer.apply({"params": {"kernel": w.transpose(2, 3, 0, 1), "bias": b}},
                                  jnp.asarray(x)))
    up = prg.FlaxConvTranspose2d(6, 4)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(w))
        up.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = up(xt).permute(0, 2, 3, 1).numpy()
        pix2pix = F.conv_transpose2d(xt, up.weight, up.bias, stride=2, padding=1,
                                     output_padding=1).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 18, 22, 4)
    assert np.abs(got - want).max() <= GEN_TOL
    assert np.abs(pix2pix - want).max() > 0.1


def _small(monkeypatch, tmp_path):
    """Both packages' scripts build the ngf-8, 2-block generator; returns
    the checkpoint both read."""
    monkeypatch.setattr(jwsi, "ResnetGenerator", partial(jrg.ResnetGenerator, NGF, BLOCKS))
    monkeypatch.setattr(jtiles, "ResnetGenerator", partial(jrg.ResnetGenerator, NGF, BLOCKS))
    for mod in (jwsi, jtiles):
        monkeypatch.setattr(mod, "params_from_torch",
                            partial(jrg.params_from_torch, ngf=NGF, n_blocks=BLOCKS))
    for mod in (pwsi, ptiles):
        monkeypatch.setattr(mod, "params_from_torch",
                            partial(prg.params_from_torch, ngf=NGF, n_blocks=BLOCKS))
        monkeypatch.setattr(mod, "build_generator",
                            partial(prg.build_generator, ngf=NGF, n_blocks=BLOCKS))
    ckpt = tmp_path / "latest_net_G.pth"
    torch.save({k: torch.from_numpy(v) for k, v in pix2pix_state().items()}, ckpt)
    return str(ckpt)


def test_cycle_gan_wsi_inference_within_one_step(tmp_path, monkeypatch):
    """The slide CLI (tile 64, batch 4: three batches, the last partial;
    the slide's edges cut tiles) within one uint8 step of the JAX script,
    every level of the pyramid."""
    ckpt = _small(monkeypatch, tmp_path)
    img = np.random.default_rng(4).integers(0, 256, (3, 150, 200), dtype=np.uint8)
    slide = tmp_path / "he.tiff"
    write_pyramid(str(slide), img, n_levels=2, tile_size=64, mpp=0.5)
    outs = [tmp_path / "port.tiff", tmp_path / "jax.tiff"]
    args = ["--slide_path", str(slide), "--checkpoint", ckpt, "--tile_size", "64",
            "--batch_size", "4"]
    pwsi.main(args + ["--out_path", str(outs[0]), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["cycle_gan_wsi_inference.py"] + args
                        + ["--out_path", str(outs[1])])
    jwsi.main()
    got, want = TiffSlide(str(outs[0])), TiffSlide(str(outs[1]))
    assert got.n_levels == want.n_levels == 4 and got.mpp == pytest.approx(0.5)
    for lvl in range(4):
        dims = want.level_dimensions[lvl]
        a = got.read_region((0, 0), lvl, dims).astype(int)
        b = want.read_region((0, 0), lvl, dims).astype(int)
        assert np.abs(a - b).max() <= 1, lvl
    assert got.read_region((0, 0), 0, (200, 150)).std() > 1


def test_normalize_tiles_within_one_step(tmp_path, monkeypatch):
    """The tile CLI over a dataframe of five PNG tiles (batch 2) writes
    same-named tiles within one uint8 step of the JAX script's."""
    cv2 = pytest.importorskip("cv2")
    ckpt = _small(monkeypatch, tmp_path)
    g = np.random.default_rng(5)
    rows = ["image_path"]
    for i in range(5):
        path = tmp_path / "tiles" / f"t{i}.png"
        path.parent.mkdir(exist_ok=True)
        cv2.imwrite(str(path), g.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        rows.append(str(path))
    csv = tmp_path / "tiles.csv"
    csv.write_text("\n".join(rows) + "\n")
    args = ["--tile_dataframe", str(csv), "--checkpoint", ckpt, "--batch_size", "2"]
    ptiles.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["normalize_tiles.py"] + args
                        + ["--out_dir", str(tmp_path / "jax")])
    jtiles.main()
    for i in range(5):
        a = cv2.imread(str(tmp_path / "port" / f"t{i}.png")).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / f"t{i}.png")).astype(int)
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1


def test_scripts_need_a_card_or_the_cpu(tmp_path, monkeypatch):
    """Without a card and without ``--device cpu`` the generator is not
    built on the CPU behind the caller's back."""
    ckpt = _small(monkeypatch, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pwsi.main(["--slide_path", "unused.tiff", "--checkpoint", ckpt, "--out_path", "x"])
