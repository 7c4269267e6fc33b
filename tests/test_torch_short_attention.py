"""K6 (short-sequence attention over [B, H, S, D]) and dot_product_attention
in the PyTorch port against the JAX package.

On the CPU the port's ``dot_product_attention`` runs the plain versions
(``short_attention_reference`` up to 512 tokens, ``flash_reference`` above),
held against the JAX ``dot_product_attention(impl="flash_interpret")``,
which runs the JAX kernels ``_short_kernel`` (S <= 512) and ``_flash_kernel``
in interpret mode, and its gradients against ``jax.grad`` through the same
route. The ``gpu`` tests hold K6 against its plain version on the card; they
skip here. Run them on a machine with a card (tests/conftest.py imports jax,
which that machine lacks):

    python -m pytest tests/test_torch_short_attention.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import attention as port

torch.set_num_threads(2)

# f32: the same math in another order of summation
RTOL = 1e-5
GRAD_RTOL = 1e-4
# bf16, scaled to the reference: (max |err| / max |ref|, ||err|| / ||ref||);
# the frameworks round the probabilities and the output at other places
BF16_TOL = (2e-2, 1e-2)
CARD_TOL = {torch.bfloat16: BF16_TOL, torch.float32: (1e-4, 1e-5)}


def _qkv(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def _jax_dpa(q, k, v, dtype=None):
    import jax.numpy as jnp

    from mipheivit_tpu.ops import dot_product_attention

    ts = [jnp.asarray(t) if dtype is None else jnp.asarray(t, dtype) for t in (q, k, v)]
    return np.asarray(dot_product_attention(*ts, impl="flash_interpret").astype(jnp.float32))


def _scaled(got, want):
    err = got - want
    return np.abs(err).max() / np.abs(want).max(), np.linalg.norm(err) / np.linalg.norm(want)


@pytest.mark.parametrize("s,d", [(37, 32), (128, 64), (329, 64)])
def test_matches_jax_kernel(s, d):
    q, k, v = _qkv(2, 3, s, d, seed=s)
    want = _jax_dpa(q, k, v)
    got = port.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 3, s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_bf16_matches_jax_kernel():
    q, k, v = _qkv(2, 3, 77, 64, seed=1)
    want = _jax_dpa(q, k, v, "bfloat16")
    got = port.dot_product_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    rel, fro = _scaled(got.float().numpy(), want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


def test_reference_normalises_before_rounding():
    """bf16: p is divided by its f32 row sum and only then rounded (K6's
    order), not rounded and the output divided (K1's)."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(1, 2, 40, 64, seed=2))
    got = port.short_attention_reference(q, k, v)
    logits = q.double() @ k.double().transpose(-1, -2) / 8.0
    p = torch.softmax(logits, -1).float().bfloat16()
    want = (p.double() @ v.double()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


def test_head_major_views_of_a_token_major_buffer():
    """Any strides: heads of a [B, S, H*D] buffer viewed as [B, H, S, D]."""
    q, k, v = _qkv(2, 3, 50, 64, seed=3)
    buf = torch.from_numpy(np.concatenate([t.transpose(0, 2, 1, 3).reshape(2, 50, 192)
                                           for t in (q, k, v)], -1))
    views = [buf[..., i * 192:(i + 1) * 192].view(2, 50, 3, 64).transpose(1, 2) for i in range(3)]
    got = port.dot_product_attention(*views)
    want = port.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_cpu_runs_plain_version_without_launch():
    for key in port.launch_counts:
        port.launch_counts[key] = 0
    short = [torch.from_numpy(t) for t in _qkv(1, 2, 40, 64, seed=4)]
    out = port.dot_product_attention(*short)
    torch.testing.assert_close(out, port.short_attention_reference(*short), rtol=0, atol=0)
    long = [torch.from_numpy(t) for t in _qkv(1, 2, 520, 64, seed=5)]
    out = port.dot_product_attention(*long)
    rows = [t.transpose(1, 2).reshape(1, 520, 128) for t in long]
    want = port.flash_reference(*rows, 2)[0].view(1, 520, 2, 64).transpose(1, 2)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert all(n == 0 for n in port.launch_counts.values())


def test_other_devices_raise():
    q = torch.empty((1, 2, 40, 64), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one"):
        port.dot_product_attention(q, q, q)
    with pytest.raises(ValueError, match="CPU or all on one"):
        port.dot_product_attention(torch.zeros((1, 2, 40, 64)), q, q)


def _jax_grads(q, k, v, r):
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops import dot_product_attention

    def loss(q, k, v):
        return jnp.sum(dot_product_attention(q, k, v, impl="flash_interpret") * r)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("s,d", [(77, 32), (576, 64)], ids=["short_k6", "long_k4"])
def test_autograd_matches_jax_grad(s, d):
    """dq, dk, dv: S <= 512 through K6's plain recompute backward (JAX's
    _flash_bwd_rule without lse), S > 512 through K4/K5's route (JAX's
    _long_backward kernels, interpreted)."""
    q, k, v = _qkv(1, 2, s, d, seed=6 + s)
    r = np.random.default_rng(7).standard_normal((1, 2, s, d)).astype(np.float32)
    want = _jax_grads(q, k, v, r)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (port.dot_product_attention(*ts) * torch.from_numpy(r)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max())


@pytest.mark.parametrize("d", [8, 12, 32, 36, 40])
def test_padded_route_matches_jax_kernel(d):
    """What the card computes for K6 at a head dim below 64, a multiple of 8
    or not: q, k, v zero-padded to 64 along D, the plain version with the scale of the
    original D, the output sliced back; against the JAX kernel (interpreted)
    at test_autograd_matches_jax_grad's short shape, the output, and the
    gradients of q, k and v by autograd through the padded route."""
    import torch.nn.functional as F

    s = 77
    q, k, v = _qkv(1, 2, s, d, seed=6 + s + d)
    r = np.random.default_rng(7).standard_normal((1, 2, s, d)).astype(np.float32)
    want = _jax_dpa(q, k, v)
    want_grads = _jax_grads(q, k, v, r)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = port.short_attention_reference(*(F.pad(t, (0, 64 - d)) for t in ts),
                                         scale=1.0 / np.sqrt(d))
    assert not out[..., d:].any()
    got = out[..., :d]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    (got * torch.from_numpy(r)).sum().backward()
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_qkv(b, h, s, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, h, s, 64), generator=g).to(device, dtype) for _ in range(3)]


def _card_scaled(got, want):
    err = got.float() - want.float()
    return ((err.abs().max() / want.float().abs().max()).item(),
            (err.norm() / want.float().norm()).item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,s", [(4, 24, 329), (3, 2, 1), (3, 2, 16), (2, 2, 63), (2, 2, 65),
                                   (2, 3, 200), (1, 2, 512)])
def test_kernel_matches_plain_on_card(cuda, b, h, s, dtype):
    q, k, v = _card_qkv(b, h, s, dtype, cuda, seed=s)
    port.launch_counts["short"] = 0
    with torch.inference_mode():
        got = port.dot_product_attention(q, k, v)
        want = port.short_attention_reference(q, k, v)
        torch.cuda.synchronize()
    assert port.launch_counts["short"] == 1
    assert got.shape == (b, h, s, 64) and got.dtype == dtype
    rel, fro = _card_scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
def test_kernel_reads_strided_heads_on_card(cuda):
    """q, k, v as head-major views of one fused [B, S, 3*H*D] buffer."""
    g = torch.Generator().manual_seed(8)
    buf = torch.randn((4, 329, 3 * 24 * 64), generator=g).to(cuda, torch.bfloat16)
    q, k, v = (buf[..., i * 1536:(i + 1) * 1536].view(4, 329, 24, 64).transpose(1, 2)
               for i in range(3))
    with torch.inference_mode():
        got = port.dot_product_attention(q, k, v)
        want = port.short_attention_reference(q, k, v)
        torch.cuda.synchronize()
    rel, fro = _card_scaled(got, want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [4, 8], ids=["unaligned_base", "aligned_base"])
def test_kernel_reads_rows_tma_cannot_take_on_card(cuda, offset):
    """bf16 head-major views of q, k and v in a [3, B, S, H*64 + 12] buffer:
    a row stride of H*64 + 12 values (not a multiple of 8, so not of 16
    bytes), at a base 8 or 16 bytes into each row. The entry point copies such operands
    contiguous for K6's tensor maps; one launch, held to the plain version
    on the same views."""
    g = torch.Generator().manual_seed(12)
    buf = torch.randn((3, 4, 329, 4 * 64 + 4 + 8), generator=g).to(cuda, torch.bfloat16)
    q, k, v = (buf[i, ..., offset:offset + 256].view(4, 329, 4, 64).transpose(1, 2)
               for i in range(3))
    assert q.stride(2) % 8 and not q.is_contiguous()
    port.launch_counts["short"] = 0
    with torch.inference_mode():
        got = port.dot_product_attention(q, k, v)
        want = port.short_attention_reference(q, k, v)
        torch.cuda.synchronize()
    assert port.launch_counts["short"] == 1
    rel, fro = _card_scaled(got, want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


@pytest.mark.gpu
def test_long_sequences_go_to_k4_on_card(cuda):
    q, k, v = _card_qkv(1, 2, 640, torch.bfloat16, cuda, seed=9)
    for key in port.launch_counts:
        port.launch_counts[key] = 0
    with torch.inference_mode():
        got = port.dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    assert port.launch_counts["flash"] == 1 and port.launch_counts["short"] == 0
    rows = [t.transpose(1, 2).reshape(1, 640, 128) for t in (q, k, v)]
    want = port.flash_reference(*rows, 2)[0].view(1, 640, 2, 64).transpose(1, 2)
    rel, fro = _card_scaled(got, want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


@pytest.mark.gpu
def test_backward_on_card_matches_cpu(cuda):
    """f32: K6 forward and the plain recompute backward on the card against
    the CPU."""
    q, k, v = _card_qkv(2, 2, 100, torch.float32, torch.device("cpu"), seed=10)
    r = torch.randn((2, 2, 100, 64), generator=torch.Generator().manual_seed(11))
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        (port.dot_product_attention(*ts) * r.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [8, 12, 32, 36, 40])
def test_head_dims_below_64_on_card(cuda, d, dtype):
    """Head dims below 64, multiples of 8 or not, through K6, zero-padded to
    64 with the scale of their own D, against the plain version at that
    D."""
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn((3, 4, 200, d), generator=g).to(cuda, dtype) for _ in range(3))
    port.launch_counts["short"] = 0
    with torch.inference_mode():
        got = port.dot_product_attention(q, k, v)
        want = port.short_attention_reference(q, k, v)
        torch.cuda.synchronize()
    assert port.launch_counts["short"] == 1
    assert got.shape == (3, 4, 200, d) and got.dtype == dtype
    rel, fro = _card_scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [80, 128])
def test_head_dims_80_and_128_on_card(cuda, d, dtype):
    """dot_product_attention at head dims above 64 up to 512 tokens takes
    K4's 128-wide instance (K6 holds heads up to 64), held against K6's
    plain version at that D, with one K4 launch and none of K6."""
    q, k, v = (torch.from_numpy(np.random.default_rng(d + i).standard_normal(
        (3, 4, 200, d)).astype(np.float32)).to(cuda, dtype) for i in range(3))
    before = dict(port.launch_counts)
    with torch.inference_mode():
        got = port.dot_product_attention(q, k, v)
        want = port.short_attention_reference(q, k, v)
        torch.cuda.synchronize()
    assert port.launch_counts["flash"] == before["flash"] + 1
    assert port.launch_counts["short"] == before["short"]
    assert got.shape == (3, 4, 200, d) and got.dtype == dtype
    rel, fro = _card_scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 40, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):   # 136: above 128
        port.dot_product_attention(*[torch.zeros((1, 2, 40, 136), device=cuda)] * 3)
    with pytest.raises(ValueError, match="head dim"):   # 80: above K6's 64 (K4's route)
        port._short_cuda(*[torch.zeros((1, 2, 40, 80), device=cuda)] * 3)
    with pytest.raises(ValueError, match="S <= 512"):    # longer sequences are K4's
        port._short_cuda(*[torch.zeros((1, 2, 513, 64), device=cuda)] * 3)
    with pytest.raises(ValueError, match="bf16 or f32"):
        port.dot_product_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="unit stride"):
        port._short_cuda(q, q, torch.zeros((1, 2, 64, 40), device=cuda).transpose(-1, -2))
    with pytest.raises(ValueError, match="launched raw with grad enabled"):
        port._short_cuda(q.requires_grad_(), q, q)


@pytest.mark.gpu
def test_failed_launch_raises(cuda):
    """A launch the card refuses (a grid deeper than 65535 batch items)
    surfaces as an error, and counts no launch."""
    q = torch.zeros((65536, 1, 1, 64), dtype=torch.bfloat16, device=cuda)
    port.launch_counts["short"] = 0
    with torch.inference_mode(), pytest.raises(RuntimeError, match="K6 short attention launch"):
        port.dot_product_attention(q, q, q)
    assert port.launch_counts["short"] == 0
