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
def test_kernel_rejects_what_it_does_not_take(cuda):
    qkv = torch.zeros((1, 40, 3 * 128), device=cuda)
    with pytest.raises(ValueError, match="S <= 512"):   # longer sequences are K4's
        port._attention_cuda(*torch.zeros((1, 513, 3 * 128), device=cuda).chunk(3, -1), 2)
    with pytest.raises(ValueError, match="head dim"):
        port.attention_qkv(qkv, 4)
    with pytest.raises(ValueError, match="bf16 or f32"):
        port.attention_qkv(qkv.half(), 2)
    with pytest.raises(ValueError, match="forward only"):
        port.attention_qkv(qkv.requires_grad_(), 2)
