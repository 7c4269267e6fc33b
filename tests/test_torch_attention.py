"""K1 attention in the PyTorch port against the JAX package.

On the CPU the port's wrappers run the plain version, which is held against
the JAX kernel run in interpret mode. The ``gpu`` tests hold the CUDA kernel
against the plain version on the card; they skip here. Run them on a machine
with a card (tests/conftest.py imports jax, which that machine lacks):

    python -m pytest tests/test_torch_attention.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import attention as port

torch.set_num_threads(2)

# f32 budgets: the same math in another summation order (exp2 and 1/l on
# the output in JAX's kernel, exp and p/l in the plain version)
ATOL, RTOL = 2e-5, 1e-4


def _jax_attention():
    from mipheivit_tpu.ops import attention

    return attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, h, d=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 3 * h * d)).astype(np.float32)


@pytest.mark.parametrize("s", [329, 40])
def test_attention_qkv_matches_jax(s):
    import jax.numpy as jnp

    qkv = _qkv(2, s, 2)
    want = np.asarray(_jax_attention().attention_qkv(
        jnp.asarray(qkv), 2, impl="flash_interpret"))
    got = port.attention_qkv(torch.from_numpy(qkv), 2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s", [329, 40])
def test_attention_bshd_matches_jax(s):
    import jax.numpy as jnp

    q, k, v = np.split(_qkv(2, s, 2, seed=1), 3, axis=-1)
    want = np.asarray(_jax_attention().attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
        impl="flash_interpret"))
    got = port.attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_fused_equals_split_on_cpu():
    qkv = torch.from_numpy(_qkv(2, 329, 3, seed=2))
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    torch.testing.assert_close(port.attention_qkv(qkv, 3),
                               port.attention_bshd(q, k, v, 3), rtol=0, atol=0)


def test_cpu_runs_plain_version_without_launch():
    port.launch_counts["attention"] = 0
    qkv = torch.from_numpy(_qkv(1, 40, 2, seed=3))
    out = port.attention_qkv(qkv, 2)
    assert out.shape == (1, 40, 128)
    assert port.launch_counts["attention"] == 0
    q, k, v = qkv.chunk(3, dim=-1)
    torch.testing.assert_close(out, port.attention_reference(q, k, v, 2),
                               rtol=0, atol=0)


def test_other_devices_raise():
    """Only a CPU tensor takes the plain version; anything else that is not
    CUDA raises instead of being computed somewhere."""
    qkv = torch.empty((1, 40, 3 * 128), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one"):
        port.attention_qkv(qkv, 2)


@pytest.mark.parametrize("s", [1, 329, 600])
@pytest.mark.parametrize("d", [32, 40])
def test_other_head_dims_match_jax_entry_point(d, s):
    """Head dims 32 and 40, which the kernels take zero-padded to 64 (see
    test_padded_route_matches_jax_entry_point): on the CPU, at the original
    D, against the JAX entry point, up to 512 tokens and above, the output
    and the gradients of q, k and v."""
    import jax
    import jax.numpy as jnp

    h = 3
    q, k, v = np.split(_qkv(1, s, h, d=d, seed=s + d), 3, axis=-1)
    r = np.random.default_rng(s + 1).standard_normal((1, s, h * d)).astype(np.float32)
    jatt = _jax_attention()

    def loss(*qkv):
        return jnp.sum(jatt.attention_bshd(*qkv, h) * r)

    jargs = [jnp.asarray(t) for t in (q, k, v)]
    want = np.asarray(jatt.attention_bshd(*jargs, h))
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(t.copy()).requires_grad_() for t in (q, k, v)]
    got = port.attention_bshd(*ts, h)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    # held to the largest gradient of the three: at S = 1 the softmax is
    # constant, so dq and dk are 0 up to f32 rounding in both
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grads)
    for t, g in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("s", [1, 329, 600])
@pytest.mark.parametrize("d", [8, 12, 32, 36, 40])
def test_padded_route_matches_jax_entry_point(d, s):
    """What the card computes for a head dim below 64, a multiple of 8 or
    not (12, 36: the JAX entry point serves them through XLA): each head
    zero-padded to 64 (``pad_heads``), the plain version at 64 with the scale of the
    original D (K1's up to 512 tokens; K4's and K5's above, from K4's lse),
    sliced back (``unpad_heads``). On the inputs of
    test_other_head_dims_match_jax_entry_point, against the JAX entry point:
    the output and the gradients of q, k and v within the same f32
    tolerances, and the padded columns of out, dq, dk and dv exactly 0."""
    import jax
    import jax.numpy as jnp

    h = 3
    q, k, v = np.split(_qkv(1, s, h, d=d, seed=s + d), 3, axis=-1)
    r = np.random.default_rng(s + 1).standard_normal((1, s, h * d)).astype(np.float32)
    jatt = _jax_attention()

    def loss(*qkv):
        return jnp.sum(jatt.attention_bshd(*qkv, h) * r)

    jargs = [jnp.asarray(t) for t in (q, k, v)]
    want = np.asarray(jatt.attention_bshd(*jargs, h))
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(*jargs)

    qp, kp, vp, rp = (port.pad_heads(torch.from_numpy(t.copy()), h) for t in (q, k, v, r))
    scale = 1.0 / np.sqrt(d)
    if s <= port.MAX_SEQ:
        out, lse = port.attention_reference(qp, kp, vp, h, scale), None
    else:
        out, lse = port.flash_reference(qp, kp, vp, h, scale=scale)
    grads = port.flash_backward_reference(qp, kp, vp, out, lse, rp, h, scale=scale)
    for t in (out, *grads):
        assert t.shape == (1, s, h * 64)
        assert not t.view(1, s, h, 64)[..., d:].any()
    np.testing.assert_allclose(port.unpad_heads(out, h, d).numpy(), want, atol=ATOL, rtol=RTOL)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(port.unpad_heads(g, h, d).numpy(), np.asarray(w),
                                   atol=1e-4 * scale, rtol=1e-4)


def test_pad_heads_round_trip():
    """pad_heads puts each head's D values first and zeros after them;
    unpad_heads takes them back; at D = 64 both return their input."""
    t = torch.arange(2 * 5 * 3 * 40, dtype=torch.float32).reshape(2, 5, 120)
    p = port.pad_heads(t, 3)
    assert p.shape == (2, 5, 192)
    torch.testing.assert_close(p.view(2, 5, 3, 64)[..., :40], t.view(2, 5, 3, 40),
                               rtol=0, atol=0)
    assert not p.view(2, 5, 3, 64)[..., 40:].any()
    torch.testing.assert_close(port.unpad_heads(p, 3, 40), t, rtol=0, atol=0)
    full = torch.zeros((1, 4, 128))
    assert port.pad_heads(full, 2) is full and port.unpad_heads(full, 2, 64) is full


def test_reference_casts_probs_to_value_dtype():
    """bf16 inputs: p is rounded to bf16 before p . v, as in JAX."""
    import jax.numpy as jnp

    q, k, v = np.split(_qkv(1, 40, 2, seed=4), 3, axis=-1)
    want = np.asarray(_jax_attention()._attn_reference(
        *(jnp.asarray(t.reshape(1, 40, 2, 64).transpose(0, 2, 1, 3),
                      jnp.bfloat16) for t in (q, k, v)), 40)
        .astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(1, 40, 128)
    got = port.attention_reference(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), 2)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the output scale: the sums run in another order
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


def _cases(device):
    """Flagship shapes: bf16 fused, bf16 split (LoRA-live), f32 fused."""
    rng = np.random.default_rng(10)
    h = 24
    big = torch.from_numpy(rng.standard_normal(
        (64, 329, 3 * h * 64)).astype(np.float32)).to(device, torch.bfloat16)
    hd = h * 64
    q_split = big[..., :hd].clone()          # a fresh tensor (q + LoRA)
    small = torch.from_numpy(rng.standard_normal(
        (2, 329, 3 * h * 64)).astype(np.float32)).to(device)
    return {
        "bf16_fused": (big[..., :hd], big[..., hd:2 * hd], big[..., 2 * hd:]),
        "bf16_split": (q_split, big[..., hd:2 * hd], big[..., 2 * hd:]),
        "f32_fused": (small[..., :hd], small[..., hd:2 * hd], small[..., 2 * hd:]),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("case,tol", [("bf16_fused", 2e-2), ("bf16_split", 2e-2),
                                      ("f32_fused", 1e-4)])
def test_kernel_matches_plain_on_card(cuda, case, tol):
    q, k, v = _cases(cuda)[case]
    with torch.inference_mode():
        before = port.launch_counts["attention"]
        got = port.attention_bshd(q, k, v, 24)
        torch.cuda.synchronize()
        assert port.launch_counts["attention"] == before + 1
        want = port.attention_reference(q, k, v, 24)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (case, err)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 16, 63, 64, 65, 200, 512])
def test_kernel_ragged_lengths_on_card(cuda, s):
    qkv = torch.from_numpy(_qkv(3, s, 2, seed=s)).to(cuda)
    with torch.inference_mode():
        got = port.attention_qkv(qkv, 2)
        q, k, v = qkv.chunk(3, dim=-1)
        want = port.attention_reference(q, k, v, 2)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 32, 64])
@pytest.mark.parametrize("s", [1, 16, 63, 64, 65, 200, 329, 512])
def test_bf16_kernel_ragged_lengths_at_batch_on_card(cuda, s, b):
    """The bf16 kernel (one block per head and batch item, the last key
    tile cut to the live keys rounded up to 16) against the plain version,
    scaled to the reference: bf16 rounds p against the running max."""
    qkv = torch.from_numpy(_qkv(b, s, 4, seed=s + b)).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        before = port.launch_counts["attention"]
        got = port.attention_qkv(qkv, 4)
        torch.cuda.synchronize()
        assert port.launch_counts["attention"] == before + 1
        want = port.attention_reference(*qkv.chunk(3, dim=-1), 4)
    err = got.float() - want.float()
    assert torch.isfinite(got).all()
    assert err.abs().max() <= 2e-2 * want.float().abs().max()
    assert err.norm() <= 1e-2 * want.float().norm()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [8, 12, 32, 36, 40])
def test_head_dims_below_64_on_card(cuda, d, dtype):
    """Head dims below 64, multiples of 8 or not, run through K1,
    zero-padded to 64 with the scale of their own D, against the plain
    version at that D; bf16 scaled to the reference as above, f32 within
    1e-4."""
    qkv = torch.from_numpy(_qkv(4, 329, 3, d=d, seed=d)).to(cuda, dtype)
    with torch.inference_mode():
        before = port.launch_counts["attention"]
        got = port.attention_qkv(qkv, 3)
        torch.cuda.synchronize()
        assert port.launch_counts["attention"] == before + 1
        want = port.attention_reference(*qkv.chunk(3, dim=-1), 3)
    assert got.shape == (4, 329, 3 * d) and got.dtype == dtype
    err = got.float() - want.float()
    if dtype == torch.float32:
        assert err.abs().max() <= 1e-4
    else:
        assert err.abs().max() <= 2e-2 * want.float().abs().max()
        assert err.norm() <= 1e-2 * want.float().norm()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [80, 128])
def test_head_dims_80_and_128_on_card(cuda, d, dtype):
    """Head dims above 64 up to 512 tokens take K4's 128-wide instance (K1
    holds heads up to 64; 80 zero-padded to 128, the scale of its own D),
    held against K1's plain version at that D as above, with one K4
    launch and no K1 launch."""
    qkv = torch.from_numpy(_qkv(4, 329, 3, d=d, seed=d)).to(cuda, dtype)
    with torch.inference_mode():
        before = dict(port.launch_counts)
        got = port.attention_qkv(qkv, 3)
        torch.cuda.synchronize()
        assert port.launch_counts["flash"] == before["flash"] + 1
        assert port.launch_counts["attention"] == before["attention"]
        want = port.attention_reference(*qkv.chunk(3, dim=-1), 3)
    assert got.shape == (4, 329, 3 * d) and got.dtype == dtype
    err = got.float() - want.float()
    if dtype == torch.float32:
        assert err.abs().max() <= 1e-4
    else:
        assert err.abs().max() <= 2e-2 * want.float().abs().max()
        assert err.norm() <= 1e-2 * want.float().norm()


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    qkv = torch.zeros((1, 40, 3 * 128), device=cuda)
    with pytest.raises(ValueError, match="S <= 512"):   # longer sequences are K4's
        port._attention_cuda(*torch.zeros((1, 513, 3 * 128), device=cuda).chunk(3, -1), 2)
    with pytest.raises(ValueError, match="head dim"):   # 128: above K1's 64 (K4's route)
        port._attention_cuda(*qkv.chunk(3, -1), 1)
    launches = dict(port.launch_counts)
    with pytest.raises(ValueError, match="head dim"):   # 136: above 128
        port.attention_qkv(torch.zeros((1, 40, 3 * 136), device=cuda), 1)
    with pytest.raises(ValueError, match="head dim"):   # 136: above 128
        port.attention_qkv(torch.zeros((1, 40, 3 * 272), device=cuda), 2)
    assert port.launch_counts == launches
    with pytest.raises(ValueError, match="bf16 or f32"):
        port.attention_qkv(qkv.half(), 2)
    with pytest.raises(ValueError, match="launched raw with grad enabled"):
        port._attention_cuda(*qkv.requires_grad_().chunk(3, -1), 2)
