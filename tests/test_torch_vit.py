"""The port's VisionTransformer against the JAX one (K1 in interpret mode on
the JAX side, the plain attention on the port's), weights carried across
by ``state_dict_from_jax``."""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.infer.loading import merge_lora
from mipheivit_tpu_torch.models import ViTConfig, VisionTransformer
from mipheivit_tpu_torch.models.convert import state_dict_from_jax

torch.set_num_threads(2)

TAPS = (0, 1)
GEOM = dict(img_size=(256, 256), patch_size=14, embed_dim=128, depth=2,
            num_heads=2, mlp_hidden_dim=256, reg_tokens=4)


@pytest.fixture(scope="module")
def jax_vit():
    """JAX ViT with LoRA rank 4 (non-zero B, layerscale at trained scale):
    its variables, one input, and its final tokens and taps."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu.models import VisionTransformer as JaxVisionTransformer

    cfg = JaxViTConfig(**GEOM, lora_rank=4, attn_impl="flash_interpret", remat=False)
    model = JaxVisionTransformer(cfg, intermediates=TAPS)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, 256, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"])
    blocks = params["blocks"]
    for name in ("ls1", "ls2"):
        blocks[name] = rng.uniform(0.05, 0.15, blocks[name].shape).astype(np.float32)
    for lq in ("lora_q", "lora_v"):
        b = blocks["attn"][lq]["B"]
        blocks["attn"][lq]["B"] = (rng.standard_normal(b.shape) * 0.05).astype(np.float32)
    final, taps = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    assert final.shape == (2, 329, 128)
    return cfg, params, x, np.asarray(final), [np.asarray(t) for t in taps]


def _port_vit(cfg, params):
    vit = VisionTransformer(ViTConfig(**GEOM, lora_rank=cfg.lora_rank)).eval()
    state = state_dict_from_jax({"params": params}, cfg)
    vit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return vit


@pytest.mark.parametrize("merged", [False, True], ids=["lora_live", "lora_merged"])
def test_vit_matches_jax(jax_vit, merged):
    cfg, params, x, want_final, want_taps = jax_vit
    vit = _port_vit(cfg, params)
    if merged:
        merge_lora(vit)
        assert vit.cfg.lora_rank == 0
        assert not any(".lora_" in k for k in vit.state_dict())
    with torch.inference_mode():
        final, taps = vit(torch.from_numpy(x), intermediates=TAPS)
    np.testing.assert_allclose(final.numpy(), want_final, atol=1e-4, rtol=0)
    assert len(taps) == len(TAPS)
    for got, want in zip(taps, want_taps):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_vit_embed_class_gelu_matches_jax():
    """The other encoder family (sp85m-style): GELU MLP, no register tokens,
    position embedding over the class token too, no layerscale."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu.models import VisionTransformer as JaxVisionTransformer

    geom = dict(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2,
                num_heads=2, mlp_hidden_dim=256, mlp_type="gelu",
                init_values=None, reg_tokens=0, no_embed_class=False)
    jcfg = JaxViTConfig(**geom, attn_impl="flash_interpret", remat=False,
                        scan_blocks=False)
    model = JaxVisionTransformer(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))

    vit = VisionTransformer(ViTConfig(**geom)).eval()
    state = state_dict_from_jax({"params": params}, jcfg)
    vit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    with torch.inference_mode():
        got = vit(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
