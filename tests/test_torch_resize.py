"""The port's resizes against torch's F.interpolate and the JAX package."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mipheivit_tpu_torch.ops.resize import (resample_pos_embed, resize_bicubic,
                                            upsample2x_bilinear)

torch.set_num_threads(2)


@pytest.mark.parametrize("in_hw,out_hw,antialias", [
    ((18, 18), (16, 16), False),     # the flagship 14 -> 16 re-grid
    ((8, 8), (2, 2), False),
    ((5, 7), (9, 3), False),
    ((16, 16), (18, 18), True),      # a 224-px position embedding at 256 px
    ((9, 9), (4, 4), True),
])
def test_resize_bicubic_matches_interpolate_and_jax(in_hw, out_hw, antialias):
    import jax.numpy as jnp

    from mipheivit_tpu.ops.resize import resize_bicubic as jax_resize

    x = np.random.default_rng(0).standard_normal((2, 3) + in_hw).astype(np.float32)
    got = resize_bicubic(torch.from_numpy(x), out_hw, antialias=antialias)
    want = F.interpolate(torch.from_numpy(x), size=out_hw, mode="bicubic",
                         align_corners=False, antialias=antialias)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    jax_out = np.asarray(jax_resize(jnp.asarray(x), out_hw, antialias=antialias))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-5, rtol=1e-5)


def test_resize_bicubic_keeps_dtype():
    x = torch.randn(1, 2, 18, 18, dtype=torch.bfloat16)
    assert resize_bicubic(x, (16, 16)).dtype == torch.bfloat16


def test_resample_pos_embed_matches_jax():
    from mipheivit_tpu.models.import_weights import resample_pos_embed as jax_resample

    pos = np.random.default_rng(1).standard_normal((1, 1 + 16 * 16, 8)).astype(np.float32)
    got = resample_pos_embed(torch.from_numpy(pos), (18, 18), num_prefix_tokens=1)
    want = jax_resample(pos, (18, 18), num_prefix_tokens=1)
    assert got.shape == (1, 1 + 18 * 18, 8)
    np.testing.assert_array_equal(got[:, :1].numpy(), pos[:, :1])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_upsample2x_bilinear_matches_jax():
    import jax.numpy as jnp

    from mipheivit_tpu.ops.resize import upsample2x_bilinear_nhwc

    x = np.random.default_rng(2).standard_normal((2, 5, 6, 3)).astype(np.float32)
    got = upsample2x_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = np.asarray(upsample2x_bilinear_nhwc(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_resize_matrices_cached_in_inference_mode_serve_training():
    """Serving (inference mode) and then training re-grid through the same
    cached matrices: the cache must hold normal tensors."""
    x = torch.randn(1, 4, 9, 9)
    with torch.inference_mode():
        resize_bicubic(x, (5, 5))
    y = x.clone().requires_grad_()
    resize_bicubic(y, (5, 5)).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()
