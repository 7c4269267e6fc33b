"""The port's three HEMIT Swin hybrids (``models/hemit_hybrid.py``) against
the JAX package's, on the CPU in f32: tiny ``HybridSwinT``,
``HybridSwinT_2`` and ``SwinUnetGenerator`` from seeded JAX variables
carried across by ``models.convert``, and the committed
``parity_hybrid_geom.npz`` (the torch oracle's output on its seeded
HEMIT-layout checkpoint) through the port's ``hybrid_swint_from_torch``,
within the fixture's own tolerance, as ``tests/test_model_parity.py`` holds
the JAX package to it.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models import hemit_hybrid as hh
from mipheivit_tpu_torch.models.convert import hemit_state_dict_from_jax
from mipheivit_tpu_torch.models.import_hemit import hybrid_swint_from_torch
from torch_family_helpers import apply_jax, close, init_jax, load

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

GEN_TOL = 5e-4


def _pair(name):
    """(JAX module, port module, input size) of a tiny hybrid; every Swin
    stage 0 shifts."""
    from mipheivit_tpu.models import hemit_hybrid as jh

    swin = dict(embed_dim=16, num_heads=(1, 2, 4, 8))
    if name == "swinT":
        kw = dict(out_channels=4, cnn_channels=(8, 16, 32), depths=(2, 1, 1, 1), window_size=4,
                  **swin)
        return jh.HybridSwinT(**kw), hh.HybridSwinT(256, **kw), 256
    if name == "swinT_old":
        kw = dict(out_channels=5, depths=(2, 1, 2, 1), window_size=4, **swin)
        return jh.HybridSwinT_2(**kw), hh.HybridSwinT_2(128, **kw), 128
    kw = dict(out_channels=4, num_downs=8, ngf=8, depths=(2, 1, 2, 1), window_size=8,
              patch_size=8, **swin)
    return jh.SwinUnetGenerator(**kw), hh.SwinUnetGenerator(256, **kw), 256


@pytest.mark.parametrize("name", ["swinT", "swinT_old", "SwinTUnet"])
def test_hybrid_matches_jax(name):
    jm, pm, img = _pair(name)
    x = np.random.default_rng(1).standard_normal((1, img, img, 3)).astype(np.float32)
    v = init_jax(jm, x, 0, train=False)
    load(pm, hemit_state_dict_from_jax(v, pm)).eval()
    want = np.asarray(apply_jax(jm, v, x, train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert 0.05 < np.abs(want).max() < 0.999
    close(got, want, GEN_TOL)


def test_golden_fixture_through_the_port_importer():
    sys.path.insert(0, str(REPO / "scripts"))
    from make_parity_fixtures import HYBRID_GEOM, synth_input, synth_state_dict

    z = np.load(REPO / "tests/fixtures/parity_hybrid_geom.npz")
    meta = json.loads(str(z["meta"]))
    state = synth_state_dict([(k, tuple(s)) for k, s in meta["keys_shapes"]])
    model = hybrid_swint_from_torch(state, hh.HybridSwinT(256, **HYBRID_GEOM)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(synth_input())).numpy()
    np.testing.assert_allclose(got, z["out"], atol=meta["tol"]["out"], rtol=0)
