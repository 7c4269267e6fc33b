"""K7 (fused LayerNorm + matmul, ``ln_matmul``) in the PyTorch port against
the JAX package.

On the CPU the port runs K7's plain version, ``ln_matmul_reference``, held
against the JAX kernel ``_ln_matmul_kernel`` run in interpret mode
(``ln_matmul(impl="pallas_interpret")``; the JAX weight is ``[K, N]``, the
port's the ``nn.Linear`` layout ``[N, K]``), and its autograd Function
against ``jax.grad`` through the same kernel. The ``gpu`` tests hold the CUDA
kernel against the plain version on the card; they skip here. Run them on a
machine with a card (tests/conftest.py imports jax, which that machine
lacks):

    python -m pytest tests/test_torch_ln_matmul.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import mlp as port

torch.set_num_threads(2)

# f32: the same LayerNorm and product in another order of summation
RTOL = 1e-5
GRAD_RTOL = 1e-4
K, N = 256, 512           # the JAX kernel's gate: N % 256 == 0, K % 128 == 0
# scaled to the reference: (max |err| / max |ref|, ||err|| / ||ref||)
BF16_TOL = (2e-2, 1e-2)
CARD_TOL = {torch.bfloat16: BF16_TOL, torch.float32: (1e-4, 1e-5)}


def _inputs(m, seed=0, k=K, n=N):
    """x [m, k], the LayerNorm's scale and bias, the JAX layout's w [k, n]
    and b [n], from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    lns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    lnb = (rng.standard_normal(k) * 0.1).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, lns, lnb, w, b


def _jax_ln_matmul(x, lns, lnb, w, b, dtype=None):
    import jax.numpy as jnp

    from mipheivit_tpu.ops.mlp import ln_matmul

    xj = jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)
    out = ln_matmul(xj, *map(jnp.asarray, (lns, lnb, w, b)), impl="pallas_interpret")
    return np.asarray(out.astype(jnp.float32))


def _port(x, lns, lnb, w, b):
    return [torch.from_numpy(t) for t in (x, lns, lnb, w.T.copy(), b)]


@pytest.mark.parametrize("m", [37, 329])
def test_matches_jax_kernel(m):
    args = _inputs(m, seed=m)
    want = _jax_ln_matmul(*args)
    got = port.ln_matmul(*_port(*args))
    assert got.shape == (m, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_bf16_matches_jax_kernel():
    x, lns, lnb, w, b = _inputs(74, seed=1)
    want = _jax_ln_matmul(x, lns, lnb, w, b, "bfloat16")
    xt, lt, lbt, wt, bt = _port(x, lns, lnb, w, b)
    got = port.ln_matmul(xt.bfloat16().reshape(2, 37, K), lt, lbt, wt, bt)
    assert got.shape == (2, 37, N) and got.dtype == torch.bfloat16
    err = got.reshape(74, N).float().numpy() - want
    assert np.abs(err).max() <= BF16_TOL[0] * np.abs(want).max()
    assert np.linalg.norm(err) <= BF16_TOL[1] * np.linalg.norm(want)


def test_reference_rounds_once_in_bf16():
    """bf16: the normed rows rounded once, f32 product and bias, one
    rounding at the output (not the chain that rounds the product before
    the bias)."""
    x, lns, lnb, w, b = _port(*_inputs(50, seed=2))
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    got = port.ln_matmul_reference(xb, lns, lnb, wb, bb)
    xn = port.ln_rows(xb, lns, lnb, 1e-6)
    assert xn.dtype == torch.bfloat16 and got.dtype == torch.bfloat16
    want = (xn.float() @ wb.float().t() + bb.float()).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_runs_plain_version_without_launch():
    port.launch_counts["ln_matmul"] = 0
    args = _port(*_inputs(40, seed=3))
    out = port.ln_matmul(*args)
    assert port.launch_counts["ln_matmul"] == 0
    torch.testing.assert_close(out, port.ln_matmul_reference(*args), rtol=0, atol=0)


@pytest.mark.parametrize("k,n", [(128, 200), (192, 256), (128, 384)])
def test_outside_the_gate_matches_jax_entry_point(k, n):
    """N not a multiple of 256 or K not of 128, outside K7's gate (the
    card raises there): on the CPU the port's plain version against the JAX
    entry point, which runs its plain chain there; forward and gradients."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.mlp import ln_matmul

    args = _inputs(37, seed=20 + n, k=k, n=n)
    r = np.random.default_rng(21).standard_normal((37, n)).astype(np.float32)
    jargs = [jnp.asarray(t) for t in args]
    want = np.asarray(ln_matmul(*jargs))
    want_grads = jax.grad(lambda *a: jnp.sum(ln_matmul(*a) * r), argnums=tuple(range(5)))(*jargs)
    ts = [t.requires_grad_() for t in _port(*args)]
    got = port.ln_matmul(*ts)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=RTOL)
    grads = [t.grad.numpy() for t in ts]
    grads[3] = grads[3].T                               # [N, K] -> the JAX [K, N]
    for g, w_ in zip(grads, want_grads):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w_).max())


def test_other_devices_raise():
    x, lns, lnb, w, b = _port(*_inputs(4, seed=4))
    with pytest.raises(ValueError, match="CPU or all on one"):
        port.ln_matmul(x.to("meta"), lns, lnb, w, b)
    with pytest.raises(ValueError, match=r"w \[N, K\]"):
        port.ln_matmul(x, lns, lnb, w.t(), b)


def _jax_grads(x, lns, lnb, w, b, r):
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.mlp import ln_matmul

    def loss(*args):
        return jnp.sum(ln_matmul(*args, impl="pallas_interpret") * r)

    args = [jnp.asarray(t) for t in (x, lns, lnb, w, b)]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(5)))(*args)]


def test_autograd_matches_jax_grad():
    """dx, the LayerNorm's dscale and dbias, dW and db of the port's
    autograd Function against jax.grad through the interpreted kernel."""
    args = _inputs(74, seed=5)
    r = np.random.default_rng(6).standard_normal((74, N)).astype(np.float32)
    want = _jax_grads(*args, r)
    ts = [t.requires_grad_() for t in _port(*args)]
    (port.ln_matmul(*ts) * torch.from_numpy(r)).sum().backward()
    got = [t.grad.numpy() for t in ts]
    got[3] = got[3].T                                   # [N, K] -> the JAX [K, N]
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w_).max())


def test_backward_computes_only_what_is_needed():
    """A frozen projection (no grad on the LayerNorm or the weights) gets dx
    alone, equal to autograd through the plain version."""
    x, lns, lnb, w, b = _port(*_inputs(30, seed=7))
    xt, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    r = torch.from_numpy(np.random.default_rng(8).standard_normal((30, N)).astype(np.float32))
    (port.ln_matmul(xt, lns, lnb, w, b) * r).sum().backward()
    assert all(t.grad is None for t in (lns, lnb, w, b))
    (port.ln_matmul_reference(xr, lns, lnb, w, b) * r).sum().backward()
    torch.testing.assert_close(xt.grad, xr.grad, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(m, k, n, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(device, dtype)
    lns = (torch.rand(k, generator=g) + 0.5).to(device)
    lnb = (torch.randn(k, generator=g) * 0.1).to(device)
    w = (torch.randn((n, k), generator=g) / k ** 0.5).to(device, dtype)
    b = (torch.randn(n, generator=g) * 0.1).to(device, dtype)
    return x, lns, lnb, w, b


def _scaled(got, want):
    err = got.float() - want.float()
    return ((err.abs().max() / want.float().abs().max()).item(),
            (err.norm() / want.float().norm()).item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", [(658, 1536, 4608), (329, 128, 256), (1, 256, 768),
                                   (300, 384, 512)])
def test_kernel_matches_plain_on_card(cuda, m, k, n, dtype):
    args = _card_inputs(m, k, n, dtype, cuda, seed=m + k)
    port.launch_counts["ln_matmul"] = 0
    with torch.inference_mode():
        got = port.ln_matmul(*args)
        want = port.ln_matmul_reference(*args)
        torch.cuda.synchronize()
    assert port.launch_counts["ln_matmul"] == 1
    assert got.dtype == dtype and got.shape == (m, n)
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
def test_kernel_reads_strided_rows_on_card(cuda):
    """x as every other row of a buffer (row stride 2K) and a 3-D input."""
    x, lns, lnb, w, b = _card_inputs(2 * 200, 256, 512, torch.bfloat16, cuda, seed=9)
    with torch.inference_mode():
        got = port.ln_matmul(x[::2], lns, lnb, w, b)
        want = port.ln_matmul_reference(x[::2], lns, lnb, w, b)
        got3 = port.ln_matmul(x.reshape(4, 100, 256), lns, lnb, w, b)
        torch.cuda.synchronize()
    assert got3.shape == (4, 100, 512)
    assert max(_scaled(got, want)) <= 1e-2
    assert max(_scaled(got3.reshape(-1, 512), port.ln_matmul_reference(x, lns, lnb, w, b))) <= 1e-2


@pytest.mark.gpu
def test_backward_on_card_matches_cpu(cuda):
    """f32: the card's forward (K7) and backward against the CPU's."""
    args = _card_inputs(96, 128, 256, torch.float32, torch.device("cpu"), seed=11)
    r = torch.randn((96, 256), generator=torch.Generator().manual_seed(12))
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_() for t in args]
        (port.ln_matmul(*ts) * r.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, lns, lnb, w, b = _card_inputs(16, 256, 512, torch.bfloat16, cuda, seed=13)
    with pytest.raises(ValueError, match="multiple of 256"):
        port.ln_matmul(x, lns, lnb, w[:384].contiguous(), b[:384].contiguous())
    with pytest.raises(ValueError, match="multiple of 256 and K of 128"):
        port.ln_matmul(x[:, :192], lns[:192], lnb[:192], w[:, :192].contiguous(), b)
    with pytest.raises(ValueError, match="one dtype"):
        port._ln_matmul_cuda(x.half(), lns, lnb, w.half(), b.half(), 1e-6)
    with pytest.raises(ValueError, match="grad enabled"):
        port._ln_matmul_cuda(x.requires_grad_(), lns, lnb, w, b, 1e-6)


@pytest.mark.gpu
def test_failed_launch_raises(cuda):
    """A launch the card refuses (a grid taller than 65535 row blocks of 256
    rows) surfaces as an error, and counts no launch."""
    m = 65536 * 256 + 1
    x = torch.zeros((m, 128), dtype=torch.bfloat16, device=cuda)
    lns, lnb = torch.ones(128, device=cuda), torch.zeros(128, device=cuda)
    w = torch.zeros((256, 128), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(256, dtype=torch.bfloat16, device=cuda)
    port.launch_counts["ln_matmul"] = 0
    with torch.inference_mode(), pytest.raises(RuntimeError, match="K7 ln_matmul launch failed"):
        port.ln_matmul(x, lns, lnb, w, b)
    assert port.launch_counts["ln_matmul"] == 0
