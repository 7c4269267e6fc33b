"""The port's CPnet (``models/cellpose_net.py``) against the JAX package's
``cpnet_forward`` and ``eval_flows``, on the CPU in f32.

The weights are a seeded numpy state dict in cellpose's key schema (the
schema of ``tests/test_cellpose_net.py``'s torch oracle, cellpose's
``CPnet``), at a narrow ``nbase``. The JAX side reads it through
``cellpose_params_from_torch`` (BatchNorm folded); the port loads it
strictly, and also loads the JAX tree back through
``convert.cellpose_state_dict_from_jax``. Tolerance: the largest
difference within ``TOL`` of the reference's largest magnitude.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models.cellpose_net import (CPnet, build_cpnet, eval_flows,
                                                      load_cellpose_checkpoint)
from mipheivit_tpu_torch.models.convert import cellpose_state_dict_from_jax

torch.set_num_threads(2)

NBASE = (2, 8, 16, 32, 64)
TOL = 1e-4          # max |port - JAX| / max |JAX|


def seeded_state(nbase=NBASE, seed=0):
    """A cellpose CPnet state dict with seeded numpy values: weights
    N(0, 0.2), running means N(0, 0.1), variances in [0.7, 1.2], the
    diameters 30 and 17 (a rescale of 30/17)."""
    g = np.random.default_rng(seed)
    out = {}
    for k, v in CPnet(nbase).state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros((), np.int64)
        elif k.endswith("running_mean"):
            out[k] = (0.1 * g.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("running_var"):
            out[k] = g.uniform(0.7, 1.2, v.shape).astype(np.float32)
        elif k in ("diam_mean", "diam_labels"):
            out[k] = np.full((1,), 30.0 if k == "diam_mean" else 17.0, np.float32)
        else:
            out[k] = (0.2 * g.standard_normal(v.shape)).astype(np.float32)
    return out


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.fixture(scope="module")
def ref():
    """The state dict, the JAX tree of it, an input batch and JAX's forward
    and tiled evaluation."""
    import jax.numpy as jnp

    from mipheivit_tpu.models.cellpose_net import (cellpose_params_from_torch, cpnet_forward)
    from mipheivit_tpu.models.cellpose_net import eval_flows as jax_eval_flows

    state = seeded_state()
    params = cellpose_params_from_torch(state)
    g = np.random.default_rng(1)
    x = g.normal(size=(2, 48, 64, 2)).astype(np.float32)
    y, style = cpnet_forward(params, jnp.asarray(x))
    img = g.random((112, 176)).astype(np.float32)
    dp, prob = jax_eval_flows(params, img, tile=64, overlap=24, batch_size=8)
    return dict(state=state, params=params, x=x, y=np.asarray(y), style=np.asarray(style),
                img=img, dp=dp, prob=prob)


def _forward(model, x):
    with torch.no_grad():
        y, style = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy(), style.numpy()


@pytest.mark.parametrize("route", ["cellpose_state_dict", "from_jax_tree"])
def test_cpnet_forward_matches_jax(ref, route):
    """``y`` and the style of one batch equal JAX's ``cpnet_forward`` within
    TOL, the weights loaded strictly from cellpose's schema or from the JAX
    tree."""
    state = (ref["state"] if route == "cellpose_state_dict"
             else cellpose_state_dict_from_jax(ref["params"]))
    model = build_cpnet(state, device="cpu")
    assert model.nbase == NBASE and model.rescale == pytest.approx(30.0 / 17.0)
    y, style = _forward(model, ref["x"])
    close(y, ref["y"])
    close(style, ref["style"])


def test_eval_flows_matches_jax(ref):
    """Tiled, taper-blended evaluation on 112 x 176 at tile 64, overlap 24,
    batch 8: ``dp`` and ``cellprob`` equal JAX's within TOL."""
    model = build_cpnet(ref["state"], device="cpu")
    stats = {}
    dp, prob = eval_flows(model, ref["img"], tile=64, overlap=24, batch_size=8, stats=stats)
    assert dp.shape == (2, 112, 176) and prob.shape == (112, 176)
    assert dp.dtype == np.float32 and prob.dtype == np.float32
    close(dp, ref["dp"])
    close(prob, ref["prob"])
    assert stats["tiles"] == 12 and stats["net_s"] > 0


def test_checkpoint_file_matches_jax_importer(ref, tmp_path):
    """A cellpose ``.pth`` (a state dict of tensors) through
    ``load_cellpose_checkpoint`` computes what the JAX importer's tree
    computes from the same file."""
    from mipheivit_tpu.models.cellpose_net import cpnet_forward
    from mipheivit_tpu.models.cellpose_net import load_cellpose_checkpoint as jax_load

    path = tmp_path / "cp_nuclei.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in ref["state"].items()}, path)
    model = load_cellpose_checkpoint(path, device="cpu")
    params = jax_load(str(path))
    assert params["diam_labels"] == float(model.diam_labels)
    y, _ = _forward(model, ref["x"])
    close(y, np.asarray(cpnet_forward(params, ref["x"])[0]))


def test_checkpoint_without_diameters_and_strict_keys():
    """A state dict without the diameter entries loads with cellpose's 30 px
    and no rescale; an unknown key is refused."""
    state = {k: v for k, v in seeded_state().items() if not k.startswith("diam")}
    model = build_cpnet(state, device="cpu")
    assert float(model.diam_mean) == 30.0 and model.rescale == 1.0
    with pytest.raises(RuntimeError, match="Unexpected"):
        build_cpnet({**seeded_state(), "extra.weight": np.zeros(1, np.float32)}, device="cpu")


def test_build_needs_a_card_or_the_cpu(monkeypatch):
    """Without a card and without ``device="cpu"`` the model is not built on
    the CPU behind the caller's back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cpnet(seeded_state())
