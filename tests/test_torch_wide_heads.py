"""Head dims 80 and 128 through the port's attention entry points, against
the JAX package's Pallas kernels in interpret mode, on the CPU.

On the card these heads take K4's and K5's 128-wide instances (80
zero-padded to 128, with the scale of its own D): ``attention_qkv`` /
``attention_bshd`` and ``dot_product_attention`` at any length (K1 and K6
hold heads up to 64), ``flash_attention`` and its backward, and
``ln_qkv_attention`` as K7 then K4. On the CPU the same routes run the
plain versions, held here to the JAX entry points at the tolerances the
same ops' head dims up to 64 use (tests/test_torch_attention.py,
test_torch_flash.py, test_torch_flash_bwd.py, test_torch_short_attention.py,
test_torch_attn_block.py). Head dims above 128 raise on the card (the
``gpu`` tests of those files).
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import attention as port
from mipheivit_tpu_torch.ops import attn_block as port_block

torch.set_num_threads(2)

HEADS = 2
DIMS = (80, 128)
ATOL, RTOL = 2e-5, 1e-4          # test_torch_attention.py / test_torch_flash.py
BWD_ATOL = 5e-5                  # test_torch_flash_bwd.py
SHORT_RTOL = 1e-5                # test_torch_short_attention.py / test_torch_attn_block.py
GRAD_RTOL = 1e-4


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _heads(t, h=HEADS):
    """[B, S, H*D] numpy -> [B, H, S, D] jax."""
    import jax.numpy as jnp

    b, s, hd = t.shape
    return jnp.asarray(t.reshape(b, s, h, hd // h).transpose(0, 2, 1, 3))


def _unheads(t):
    t = np.asarray(t)
    b, h, s, d = t.shape
    return t.transpose(0, 2, 1, 3).reshape(b, s, h * d)


@pytest.fixture
def flash_spy(monkeypatch):
    """Counts the plain K4 forward's calls: the CPU twin of a K4 launch."""
    calls = []
    real = port.flash_reference

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(port, "flash_reference", spy)
    return calls


@pytest.mark.parametrize("entry", ["attention_qkv", "attention_bshd"])
@pytest.mark.parametrize("d", DIMS)
def test_attention_entry_points_match_jax(d, entry, flash_spy):
    """S 40 (K1's length): the K4 route's plain version against the JAX
    entry point in interpret mode."""
    import jax.numpy as jnp

    from mipheivit_tpu.ops import attention as jax_attention

    qkv = _rand(2, 40, 3 * HEADS * d, seed=d)
    if entry == "attention_qkv":
        want = jax_attention.attention_qkv(jnp.asarray(qkv), HEADS, impl="flash_interpret")
        got = port.attention_qkv(torch.from_numpy(qkv), HEADS)
    else:
        q, k, v = np.split(qkv, 3, axis=-1)
        want = jax_attention.attention_bshd(*map(jnp.asarray, (q, k, v)), HEADS,
                                            impl="flash_interpret")
        got = port.attention_bshd(*(torch.from_numpy(t.copy()) for t in (q, k, v)), HEADS)
    assert got.shape == (2, 40, HEADS * d) and len(flash_spy) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d", DIMS)
def test_flash_attention_rectangle_matches_jax_cross(d):
    """200 queries over 300 keys of which 270 are live, against
    ``flash_cross_attention`` in interpret mode (output and lse)."""
    from mipheivit_tpu.ops import attention as jax_attention

    q = _rand(1, 200, HEADS * d, seed=3)
    k, v = _rand(1, 300, HEADS * d, seed=4), _rand(1, 300, HEADS * d, seed=5)
    want = jax_attention.flash_cross_attention(_heads(q), _heads(k), _heads(v), 270,
                                               interpret=True)
    _, want_lse = jax_attention._cross_forward(_heads(q), _heads(k), _heads(v), 270, True)
    out, lse = port.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), HEADS, 270)
    np.testing.assert_allclose(out.numpy(), _unheads(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", DIMS)
def test_flash_attention_gradients_match_jax(d):
    """S 600 (the K4 / K5 route at any head dim): the output and the
    gradients of q, k and v against ``jax.grad`` through the JAX package's
    flash attention, ``_long_forward`` with its custom VJP
    (``_long_backward``), in interpret mode."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops import attention as jax_attention

    s = 600
    q, k, v, r = (_rand(1, s, HEADS * d, seed=10 + i) for i in range(4))

    def jax_out(a, b, c):
        return jax_attention.dot_product_attention(a, b, c, impl="flash_interpret")

    jargs = [_heads(t) for t in (q, k, v)]
    want = jax_out(*jargs)
    want_grads = jax.grad(lambda *a: jnp.sum(jax_out(*a) * _heads(r)),
                          argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out, _ = port.flash_attention(*ts, HEADS)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _unheads(want), atol=ATOL, rtol=RTOL)
    for name, t, g in zip(("dq", "dk", "dv"), ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), _unheads(g), atol=BWD_ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("d", DIMS)
def test_dot_product_attention_matches_jax(d, flash_spy):
    """[2, 2, 37, D] (K6's length): the K4 route's plain version against the
    JAX entry point in interpret mode, with its launch on K4's route."""
    import jax.numpy as jnp

    from mipheivit_tpu.ops import dot_product_attention

    q, k, v = (_rand(2, HEADS, 37, d, seed=20 + i) for i in range(3))
    want = np.asarray(dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                            impl="flash_interpret"))
    got = port.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, HEADS, 37, d) and len(flash_spy) == 1
    np.testing.assert_allclose(got.numpy(), want, rtol=SHORT_RTOL,
                               atol=SHORT_RTOL * np.abs(want).max())


def test_ln_qkv_attention_matches_jax_kernel():
    """2 heads of 128 at D 256 (the JAX kernel's gate): the K7 -> K4 route's
    plain versions against ``ln_qkv_attention(impl="pallas_interpret")``,
    forward and gradients."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.attn_block import ln_qkv_attention

    dm, dh, s = 256, 128, 40
    assert port_block.route(2, s, dm, HEADS, dh) == "k7+attention_qkv"
    rng = np.random.default_rng(30)
    args = (rng.standard_normal((2, s, dm)).astype(np.float32),
            rng.uniform(0.5, 1.5, dm).astype(np.float32),
            (rng.standard_normal(dm) * 0.1).astype(np.float32),
            (rng.standard_normal((dm, 3 * HEADS * dh)) / np.sqrt(dm)).astype(np.float32),
            (rng.standard_normal(3 * HEADS * dh) * 0.1).astype(np.float32))
    r = rng.standard_normal((2, s, HEADS * dh)).astype(np.float32)
    jargs = [jnp.asarray(t) for t in args]

    def jax_out(*a):
        return ln_qkv_attention(*a, HEADS, impl="pallas_interpret")

    want = np.asarray(jax_out(*jargs))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_out(*a) * r), argnums=tuple(range(5)))(*jargs)
    ts = [torch.from_numpy(t.T.copy() if i == 3 else t).requires_grad_()
          for i, t in enumerate(args)]
    got = port_block.ln_qkv_attention(*ts, HEADS)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=SHORT_RTOL, atol=SHORT_RTOL)
    grads = [t.grad.numpy() for t in ts]
    grads[3] = grads[3].T                               # [3*H*Dh, D] -> the JAX [D, 3*H*Dh]
    for g, w_ in zip(grads, want_grads):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w_).max())


@pytest.mark.parametrize("d", DIMS)
def test_padded_heads_are_exact(d):
    """What the card computes at D 80 and 128: each head zero-padded to 128
    (``pad_heads``), the plain K4 / K5 at 128 with the scale of the original
    D, sliced back (``unpad_heads``) equals the plain versions at D, and
    the padded columns of out, dq, dk and dv are exactly 0."""
    q, k, v, g = (torch.from_numpy(_rand(1, 300, HEADS * d, seed=40 + i)) for i in range(4))
    assert port.kernel_head_dim(d) == 128
    scale = 1.0 / np.sqrt(d)
    pq, pk, pv, pg = (port.pad_heads(t, HEADS) for t in (q, k, v, g))
    assert pq.shape == (1, 300, HEADS * 128)
    out_p, lse_p = port.flash_reference(pq, pk, pv, HEADS, scale=scale)
    out, lse = port.flash_reference(q, k, v, HEADS)
    torch.testing.assert_close(port.unpad_heads(out_p, HEADS, d), out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse_p, lse, atol=1e-5, rtol=0)
    grads_p = port.flash_backward_reference(pq, pk, pv, out_p, lse_p, pg, HEADS, scale=scale)
    grads = port.flash_backward_reference(q, k, v, out, lse, g, HEADS)
    for gp, gw in zip((out_p, *grads_p), (out, *grads)):
        heads = gp.view(1, 300, HEADS, 128)
        assert not heads[..., d:].any()
        torch.testing.assert_close(port.unpad_heads(gp, HEADS, d), gw, atol=BWD_ATOL, rtol=RTOL)
