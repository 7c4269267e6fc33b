"""K5 (flash-attention backward) and the attention autograd Functions of the
PyTorch port against the JAX package.

On the CPU the port runs K5's plain version, ``flash_backward_reference``,
which is held against the JAX kernels ``_bwd_dkdv_kernel`` /
``_bwd_dq_kernel`` run in interpret mode through ``_long_backward``; K1's
backward (the plain recompute) against ``jax.vjp`` of ``attention_bshd``
with the kernel interpreted. The ``gpu`` tests hold the CUDA kernel against
the plain version on the card; they skip here. Run them on a machine with a
card (tests/conftest.py imports jax, which that machine lacks):

    python -m pytest tests/test_torch_flash_bwd.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import attention as port

torch.set_num_threads(2)

# f32 budgets: the same math in another summation order (128-row blocks in
# the JAX kernels, whole rows in the plain version), gradients of unit scale
ATOL, RTOL = 5e-5, 1e-4
# K5 against its plain version on the card (csrc/flash_attention_bwd.cu),
# each of dQ, dK, dV scaled to the reference: (max |err| / max |ref|,
# ||err|| / ||ref||). bf16: p and dS rounded for the tensor cores and bf16
# outputs (measured on an H100: 0.4-0.8 % of max |ref|, chip_smoke.py
# [k5 ...]); f32 throughout in the f32 path
CARD_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-5)}


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _heads(t, h):
    """[B, S, H*D] numpy -> [B, H, S, D] jax."""
    import jax.numpy as jnp

    b, s, hd = t.shape
    return jnp.asarray(t.reshape(b, s, h, hd // h).transpose(0, 2, 1, 3))


def _unheads(t):
    t = np.asarray(t)
    b, h, s, d = t.shape
    return t.transpose(0, 2, 1, 3).reshape(b, s, h * d)


@pytest.mark.parametrize("s,seq_len", [(640, 600), (1029, 1000)])
def test_flash_backward_reference_matches_jax_long_backward(s, seq_len):
    """Keys at or past ``seq_len`` masked; the JAX launcher takes S padded to
    a multiple of 128 (zero q/k/v rows and a zero output gradient there)."""
    import jax.numpy as jnp

    from mipheivit_tpu.ops import attention as jax_attention

    h = 2
    q, k, v, g = (_rand(1, s, h * 64, seed=i) for i in range(4))
    s_pad = -(-s // 128) * 128
    pad = [(0, 0), (0, 0), (0, s_pad - s), (0, 0)]
    qj, kj, vj, gj = (jnp.pad(_heads(t, h), pad) for t in (q, k, v, g))
    out, lse = jax_attention._long_forward(qj, kj, vj, seq_len, True)
    dq, dk, dv = jax_attention._long_backward(qj, kj, vj, out, lse, gj, seq_len, True)

    out_t = torch.from_numpy(_unheads(np.asarray(out)[:, :, :s]))
    lse_t = torch.from_numpy(np.asarray(lse).reshape(1, h, s_pad)[..., :s].copy())
    got = port.flash_backward_reference(*(torch.from_numpy(t) for t in (q, k, v)), out_t, lse_t,
                                        torch.from_numpy(g), h, seq_len)
    for name, a, b in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert a.shape == (1, s, h * 64) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), _unheads(np.asarray(b)[:, :, :s]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    # masked keys get exactly zero gradient
    assert not got[1][:, seq_len:].any() and not got[2][:, seq_len:].any()


def test_k1_function_backward_matches_jax_vjp():
    """attention_qkv / attention_bshd (S <= 512, K1's route) differentiate
    through the plain recompute; held against jax.vjp of the JAX package's
    attention with its kernel's custom_vjp (``_bshd_bwd_rule``)."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops import attention as jax_attention

    h, s = 2, 69
    q, k, v, g = (_rand(2, s, h * 64, seed=10 + i) for i in range(4))
    out_j, vjp = jax.vjp(lambda a, b, c: jax_attention.attention_bshd(
        a, b, c, h, impl="flash_interpret"), *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = port.attention_bshd(qt, kt, vt, h)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    for name, a, b in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)

    # the fused-qkv entry point: gradients flow back into the one buffer
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1)).requires_grad_()
    port.attention_qkv(qkv, h).backward(torch.from_numpy(g))
    np.testing.assert_allclose(qkv.grad.numpy(), np.concatenate([np.asarray(w) for w in want], -1),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s", [300, 700])
def test_attention_autograd_matches_plain_softmax_autograd(s):
    """Both Functions (K1's route at S <= 512, K4/K5's above) against torch
    autograd through a plain softmax attention, in f32 on the CPU (the
    port's plain versions compute in f32)."""
    h = 2
    qkv = torch.from_numpy(_rand(1, s, 3 * h * 64, seed=s))
    g = torch.from_numpy(_rand(1, s, h * 64, seed=s + 1))
    port.launch_counts.update(attention=0, flash=0, flash_bwd=0, short=0)
    a = qkv.clone().requires_grad_()
    port.attention_qkv(a, h).backward(g)
    b = qkv.clone().requires_grad_()
    q, k, v = (t.reshape(1, s, h, 64).transpose(1, 2) for t in b.chunk(3, dim=-1))
    p = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1)
    (p @ v).transpose(1, 2).reshape(1, s, h * 64).backward(g)
    torch.testing.assert_close(a.grad, b.grad, atol=ATOL, rtol=RTOL)
    assert port.launch_counts == {"attention": 0, "flash": 0, "flash_bwd": 0, "short": 0}


def test_flash_backward_on_cpu_is_the_plain_version():
    h = 2
    q = torch.from_numpy(_rand(1, 600, 128, seed=20))
    k, v = (torch.from_numpy(_rand(1, 640, 128, seed=i)) for i in (21, 22))
    g = torch.from_numpy(_rand(1, 600, 128, seed=23))
    out, lse = port.flash_reference(q, k, v, h, 610)
    got = port.flash_backward(q, k, v, out, lse, g, h, 610)
    want = port.flash_backward_reference(q, k, v, out, lse, g, h, 610)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, b, sq, sk, h, dtype, seed):
    hd = h * 64
    t = torch.from_numpy(_rand(b, max(sq, sk), 3 * hd, seed=seed)).to(device, dtype)
    g = torch.from_numpy(_rand(b, sq, hd, seed=seed + 1)).to(device, dtype)
    return t[:, :sq, :hd], t[:, :sk, hd:2 * hd], t[:, :sk, 2 * hd:], g


def _assert_held(got, want, dtype, name=""):
    """``got`` within CARD_TOL of ``want``, scaled to ``want``."""
    got, want = got.float(), want.float()
    err = got - want
    max_rel = err.abs().max().item() / want.abs().max().item()
    fro_rel = (err.norm() / want.norm()).item()
    max_tol, fro_tol = CARD_TOL[dtype]
    assert max_rel <= max_tol and fro_rel <= fro_tol, (name, max_rel, fro_rel)


def _check(q, k, v, g, h, seq_len_k=None):
    with torch.no_grad():
        out, lse = port.flash_attention(q, k, v, h, seq_len_k)
        before = port.launch_counts["flash_bwd"]
        got = port.flash_backward(q, k, v, out, lse, g, h, seq_len_k)
        torch.cuda.synchronize()
        assert port.launch_counts["flash_bwd"] == before + 1
        want = port.flash_backward_reference(q, k, v, out, lse, g, h, seq_len_k)
    for name, a, w, ref in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.shape == ref.shape and a.dtype == q.dtype, name
        _assert_held(a, w, q.dtype, name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bf16_region", "f32_1029", "bf16_cross_padded"])
def test_k5_matches_plain_on_card(cuda, case):
    if case == "bf16_region":          # a 1024-px region: S = 5334, 24 heads
        _check(*_inputs(cuda, 1, 5334, 5334, 24, torch.bfloat16, 0), 24)
    elif case == "f32_1029":
        _check(*_inputs(cuda, 1, 1029, 1029, 24, torch.float32, 1), 24)
    else:                              # 1334 q rows over 5376 keys, 5334 live
        _check(*_inputs(cuda, 1, 1334, 5376, 24, torch.bfloat16, 2), 24, 5334)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [513, 577, 1301, 2049])
def test_k5_ragged_lengths_on_card(cuda, s, dtype):
    _check(*_inputs(cuda, 2, s, s, 2, dtype, s), 2)


@pytest.mark.gpu
def test_k5_runs_agree_on_card(cuda):
    """The bf16 kernel sums dQ over the key tiles with atomic adds, in an
    order that changes from run to run: two runs differ by f32 rounding of
    that sum, rounded once to bf16 (at most about one bf16 step of dq's
    largest values: 1e-2 of max |dq|, 1e-4 in norm). dK and dV are summed
    in one block each and come out the same."""
    q, k, v, g = _inputs(cuda, 1, 5334, 5334, 24, torch.bfloat16, 60)
    with torch.no_grad():
        out, lse = port.flash_attention(q, k, v, 24)
        first = port.flash_backward(q, k, v, out, lse, g, 24)
        second = port.flash_backward(q, k, v, out, lse, g, 24)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    dq1, dq2 = first[0].float(), second[0].float()
    assert (dq1 - dq2).abs().max() <= 1e-2 * dq1.abs().max()
    assert (dq1 - dq2).norm() <= 1e-4 * dq1.norm()


@pytest.mark.gpu
def test_k5_ignores_nonfinite_padding_keys(cuda):
    q, k, v, g = _inputs(cuda, 1, 700, 700, 2, torch.bfloat16, 30)
    k, v = k.clone(), v.clone()
    k[:, 650:], v[:, 650:] = float("nan"), float("inf")
    with torch.no_grad():
        out, lse = port.flash_attention(q, k, v, 2, 650)
        got = port.flash_backward(q, k, v, out, lse, g, 2, 650)
        want = port.flash_backward_reference(q, k[:, :650], v[:, :650], out, lse, g, 2)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
    assert not got[1][:, 650:].any() and not got[2][:, 650:].any()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _assert_held(a[:, :w.shape[1]], w, torch.bfloat16, name)


@pytest.mark.gpu
def test_autograd_launches_k4_then_k5_on_card(cuda):
    qkv = torch.from_numpy(_rand(1, 1029, 3 * 128, seed=40)).to(cuda).requires_grad_()
    g = torch.from_numpy(_rand(1, 1029, 128, seed=41)).to(cuda)
    before = dict(port.launch_counts)
    port.attention_qkv(qkv, 2).backward(g)
    assert port.launch_counts["flash"] == before["flash"] + 1
    assert port.launch_counts["flash_bwd"] == before["flash_bwd"] + 1
    ref = qkv.detach().clone().requires_grad_()
    q, k, v = ref.chunk(3, dim=-1)
    out, lse = port.flash_reference(q, k, v, 2)
    want = port.flash_backward_reference(q, k, v, out, lse, g, 2)
    _assert_held(qkv.grad, torch.cat(want, -1), torch.float32)


@pytest.mark.gpu
def test_head_dim_32_raises_on_card(cuda):
    """Head dim 32 runs through K4 and K5 (zero-padded to 64, the scale of
    its own D), held against the plain version at D = 32; head dim 96,
    above what the kernels take, raises on the card before any launch, in
    the forward and in K5's entry point (there is no plain route on the
    card)."""
    qkv = torch.from_numpy(_rand(1, 700, 3 * 96, seed=50)).to(cuda)
    g = torch.from_numpy(_rand(1, 700, 96, seed=51)).to(cuda)
    q, k, v = qkv.chunk(3, dim=-1)
    _check(q, k, v, g, 3)
    out, lse = port.flash_reference(q, k, v, 1)
    launches = dict(port.launch_counts)
    with pytest.raises(ValueError, match="head dim"):
        port.attention_qkv(qkv.clone().requires_grad_(), 1)
    with pytest.raises(ValueError, match="head dim"):
        port.flash_backward(q, k, v, out, lse, g, 1)
    assert port.launch_counts == launches
