"""The port's MIPHEI-ViT generator against the torch oracle's golden fixture
and against a live JAX model; the serving transforms against the plain model."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.infer.loading import merge_lora, to_fast_heads
from mipheivit_tpu_torch.models import MipheiViT, ViTConfig
from mipheivit_tpu_torch.models.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
from make_parity_fixtures import TAPS, synth_input, synth_state_dict  # noqa: E402

torch.set_num_threads(2)


def _load(model, state):
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()}, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return model.eval()


def _synth(model, seed_prefix=""):
    """Every floating entry of ``model``'s state dict from the fixture
    generator's path-keyed streams (LoRA B non-zero, BN stats non-trivial)."""
    keys = [(seed_prefix + k, tuple(v.shape)) for k, v in model.state_dict().items()
            if v.is_floating_point()]
    state = synth_state_dict(keys)
    return _load(model, {k[len(seed_prefix):]: v for k, v in state.items()})


def _tiny_cfg(**kw):
    base = dict(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2,
                num_heads=2, mlp_hidden_dim=256, reg_tokens=4)
    base.update(kw)
    return ViTConfig(**base)


def test_flagship_geometry_golden_fixture():
    """Torch-layout synthetic checkpoint -> port -> taps 0/20/39, encoder
    tokens and generator output against the frozen oracle activations, at
    the fixture's own tolerances (patch 14, 329 tokens, depth 40, head dim
    64, 14 -> 16 bicubic re-grid, 16 heads)."""
    z = np.load(REPO / "tests/fixtures/parity_flagship_geom.npz")
    meta = json.loads(str(z["meta"]))
    assert meta["taps"] == list(TAPS)
    cfg = ViTConfig(img_size=(256, 256), patch_size=14, embed_dim=128, depth=40,
                    num_heads=2, mlp_hidden_dim=256, reg_tokens=4)
    model = _load(MipheiViT(cfg, out_chans=16),
                  synth_state_dict([(k, tuple(s)) for k, s in meta["keys_shapes"]]))
    x = torch.from_numpy(synth_input())
    with torch.inference_mode():
        enc, taps = model.encoder.vit(x, intermediates=TAPS)
        out = model(x)
    tol = meta["tol"]
    for i, tap in zip(TAPS, taps):
        np.testing.assert_allclose(tap.numpy(), z[f"tap{i}"], atol=tol["tap"], rtol=0)
    np.testing.assert_allclose(enc.numpy(), z["enc"], atol=tol["enc"], rtol=0)
    np.testing.assert_allclose(out.numpy(), z["out"], atol=tol["out"], rtol=0)


@pytest.mark.parametrize("fast_heads", [False, True])
def test_live_jax_generator_matches_port(fast_heads):
    """A JAX MipheiViT with 16 heads (scanned blocks, K1 in interpret mode,
    non-trivial BN stats and layerscale) through ``state_dict_from_jax``."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.infer.loading import to_fast_heads as jax_fast_heads
    from mipheivit_tpu.models import MipheiViT as JaxMipheiViT
    from mipheivit_tpu.models import ViTConfig as JaxViTConfig

    jcfg = JaxViTConfig(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2,
                        num_heads=2, mlp_hidden_dim=256, reg_tokens=4,
                        attn_impl="flash_interpret", remat=False)
    jmodel = JaxMipheiViT(vit_cfg=jcfg, out_chans=16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, t: jmodel.init(k, t, train=False))(jax.random.PRNGKey(0), jnp.asarray(x)))
    blocks = variables["params"]["encoder"]["vit"]["blocks"]
    for name in ("ls1", "ls2"):
        blocks[name] = rng.uniform(0.05, 0.15, blocks[name].shape).astype(np.float32)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim and v.min() == 1
                   else rng.standard_normal(v.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    if fast_heads:
        jmodel, variables = jax_fast_heads(jmodel, variables)
    want = np.asarray(jax.jit(lambda v, t: jmodel.apply(v, t, train=False))(
        variables, jnp.asarray(x)))

    model = _load(MipheiViT(_tiny_cfg(), out_chans=16),
                  state_dict_from_jax(variables, jcfg, 16))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_fast_heads_match_per_head():
    model = _synth(MipheiViT(_tiny_cfg(), out_chans=5))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        out = to_fast_heads(model)(x)
    assert model.decoder.fast_heads
    assert not any(k.startswith("decoder.segmentation_head_") for k in model.state_dict())
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_merged_lora_equals_unmerged():
    model = _synth(MipheiViT(_tiny_cfg(lora_rank=8), out_chans=3))
    assert model.encoder.vit.blocks[0].attn.qkv.lora_q.B.abs().max() > 0
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        out = merge_lora(model)(x)
    assert model.vit_cfg.lora_rank == 0
    assert not any(".lora_" in k for k in model.state_dict())
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
