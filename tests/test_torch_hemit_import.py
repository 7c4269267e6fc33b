"""HEMIT-codebase checkpoints through the port's importers
(``models/import_hemit.py``) against the JAX package's, on the CPU in f32.

A HEMIT-codebase ``state_dict`` is synthesized from seeded JAX variables:
the port's layout is the HEMIT codebase's, so ``models.convert`` writes it,
with the Lightning ``generator.`` prefix, the Swin's index and mask
buffers, and for ``SwinTUnet`` the reference ``Cross_Att``'s unused
submodules. For the dual-branch generator it comes in the newer timm layout
and in the older one (each stage's downsample at the end of the stage
before). Each port importer loads it strictly; the port's forward equals
the JAX importer's tree through the JAX model.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models import import_hemit as pi
from mipheivit_tpu_torch.models.convert import hemit_state_dict_from_jax
from test_torch_hemit import SWIN, _swint_pair
from test_torch_hemit_hybrid import _pair as _hybrid_pair
from torch_family_helpers import apply_jax, close, init_jax

torch.set_num_threads(2)

GEN_TOL = 5e-4


def _reference_layout(v, pm, swin_prefix, old_timm_layout=False):
    """The HEMIT codebase's state dict of ``v``'s weights."""
    sd = {k: a for k, a in hemit_state_dict_from_jax(v, pm).items()
          if not k.endswith("num_batches_tracked")}
    out = {}
    for k, a in sd.items():
        if k.startswith(swin_prefix):
            rest = k[len(swin_prefix):]
            if old_timm_layout and ".downsample." in rest:
                parts = rest.split(".")
                parts[1] = str(int(parts[1]) - 1)
                rest = ".".join(parts)
            if rest.endswith("relative_position_bias_table"):
                n = int(round(a.shape[0] ** 0.5)) // 2 + 1
                base = swin_prefix + rest[:-len("relative_position_bias_table")]
                out[base + "relative_position_index"] = np.zeros((n * n, n * n), np.int64)
                out[base.replace("attn.", "attn_mask")] = np.zeros(1, np.float32)
            k = swin_prefix + rest
        out[f"generator.{k}"] = a
    return out


@pytest.mark.parametrize("old_timm_layout", [False, True])
def test_hemit_swint_import_matches_jax(old_timm_layout):
    from mipheivit_tpu.models.import_hemit import hemit_swint_from_torch as jax_import

    jm, pm = _swint_pair()
    x = np.random.default_rng(1).standard_normal((2, *SWIN["img_size"], 3)).astype(np.float32)
    v = init_jax(jm, x, 4, train=False)
    sd = _reference_layout(v, pm, "swinT.", old_timm_layout)
    assert any(".downsample." in k and k.split(".")[3] == "0" for k in sd) == old_timm_layout
    params, stats = jax_import(sd, jm, old_timm_layout=old_timm_layout)
    want = np.asarray(apply_jax(jm, {"params": params, "batch_stats": stats}, x, train=False))
    model = pi.hemit_swint_from_torch(sd, pm, old_timm_layout=old_timm_layout).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert 0.05 < np.abs(want).max() < 0.999
    close(got, want, GEN_TOL)


@pytest.mark.parametrize("name", ["swinT", "swinT_old", "SwinTUnet"])
def test_hybrid_import_matches_jax(name):
    from mipheivit_tpu.models import import_hemit as ji

    jm, pm, img = _hybrid_pair(name)
    x = np.random.default_rng(2).standard_normal((1, img, img, 3)).astype(np.float32)
    v = init_jax(jm, x, 5, train=False)
    sd = _reference_layout(v, pm, "swinT." if name == "SwinTUnet" else "model.")
    if name == "SwinTUnet":
        for j in range(3):     # the reference Cross_Att's unused submodules
            sd[f"generator.cross_atts.{j}.norm_unet.weight"] = np.ones(8, np.float32)
            sd[f"generator.cross_atts.{j}.linear_unet.weight"] = np.ones((8, 8), np.float32)
            sd[f"generator.cross_atts.{j}.transformer_swinT.layers.0.0.norm.weight"] = \
                np.ones(8, np.float32)
    jax_import = {"swinT": ji.hybrid_swint_from_torch, "swinT_old": ji.hybrid_swint2_from_torch,
                  "SwinTUnet": ji.swin_unet_from_torch}[name]
    params, stats = jax_import(sd, jm, (img, img))
    want = np.asarray(apply_jax(jm, {"params": params, "batch_stats": stats}, x, train=False))
    model = pi.IMPORTERS[name](sd, pm).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    close(got, want, GEN_TOL)


def test_importer_refuses_a_checkpoint_that_does_not_fit():
    jm, pm = _swint_pair()
    v = init_jax(jm, np.zeros((1, 64, 64, 3), np.float32), 4, train=False)
    sd = _reference_layout(v, pm, "swinT.")
    del sd["generator.final_layers.1.weight"]
    with pytest.raises(ValueError, match="final_layers.1.weight"):
        pi.hemit_swint_from_torch(sd, pm)
    sd["generator.final_layers.1.weight"] = np.zeros((3, 8, 7, 7), np.float32)
    sd["generator.extra.weight"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="extra.weight"):
        pi.hemit_swint_from_torch(sd, pm)
