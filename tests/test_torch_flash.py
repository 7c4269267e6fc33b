"""K4 (long-sequence flash attention) in the PyTorch port against the JAX
package.

On the CPU the port runs K4's plain version, ``flash_reference``, which is
held against the JAX kernel ``_flash_kernel`` run in interpret mode through
its launchers ``_long_forward`` and ``_cross_forward`` (out and lse). The
``gpu`` tests hold the CUDA kernel against the plain version on the card;
they skip here. Run them on a machine with a card (tests/conftest.py imports
jax, which that machine lacks):

    python -m pytest tests/test_torch_flash.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import attention as port

torch.set_num_threads(2)

# f32 budgets: the same math in another summation order (online softmax over
# 128-multiple key blocks in JAX's kernel, one exact softmax in the plain one)
ATOL, RTOL = 2e-5, 1e-4
LSE_ATOL = 1e-5
# K4 against its plain version on the card (module docstring of
# csrc/flash_attention.cu): the output scaled to the reference, (max |err| /
# max |ref|, ||err|| / ||ref||), and the lse absolute; bf16 p on the tensor
# cores and a bf16 output, f32 p throughout in the f32 path
CARD_TOL = {torch.bfloat16: (2e-2, 1e-2, 1e-3), torch.float32: (1e-4, 1e-5, 1e-5)}


def _jax_attention():
    from mipheivit_tpu.ops import attention

    return attention


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


@pytest.mark.parametrize("s", [600, 1029])
def test_flash_reference_matches_jax_long_forward(s):
    import jax.numpy as jnp

    h = 2
    q, k, v = (_rand(1, s, h * 64, seed=i) for i in range(3))
    s_pad = -(-s // 128) * 128          # _long_forward takes a 128-multiple padded S
    pad = [(0, 0), (0, 0), (0, s_pad - s), (0, 0)]
    out, lse = _jax_attention()._long_forward(
        *(jnp.pad(_heads(t, h), pad) for t in (q, k, v)), s, True)
    got_out, got_lse = port.flash_reference(*(torch.from_numpy(t) for t in (q, k, v)), h)
    assert got_out.shape == (1, s, h * 64) and got_lse.shape == (1, h, s)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), _unheads(np.asarray(out)[:, :, :s]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse).reshape(1, h, s_pad)[..., :s],
                               atol=LSE_ATOL, rtol=0)


def test_flash_reference_matches_jax_cross_forward():
    """Rectangular: 200 q rows over 700 keys, of which the last 50 are
    padding (seq_len_k = 650), as a sequence shard sees them."""
    h, sq, sk, seq_len_k = 2, 200, 700, 650
    q = _rand(1, sq, h * 64, seed=3)
    k, v = _rand(1, sk, h * 64, seed=4), _rand(1, sk, h * 64, seed=5)
    out, lse = _jax_attention()._cross_forward(
        _heads(q, h), _heads(k, h), _heads(v, h), seq_len_k, True)
    got_out, got_lse = port.flash_reference(*(torch.from_numpy(t) for t in (q, k, v)), h,
                                            seq_len_k)
    np.testing.assert_allclose(got_out.numpy(), _unheads(out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=LSE_ATOL, rtol=0)


def test_attention_qkv_long_matches_jax_flash_interpret():
    """S = 1029 (a 128-px window at patch 4) through the port's attention_qkv
    against JAX's dot_product_attention with the flash kernel interpreted."""
    h, s = 2, 1029
    qkv = _rand(2, s, 3 * h * 64, seed=6)
    q, k, v = np.split(qkv, 3, axis=-1)
    want = _unheads(_jax_attention().dot_product_attention(
        _heads(q, h), _heads(k, h), _heads(v, h), impl="flash_interpret"))
    got = port.attention_qkv(torch.from_numpy(qkv), h).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s,plain", [(512, "attention_reference"), (513, "flash_reference"),
                                     (1301, "flash_reference")])
def test_cpu_dispatch_by_length_without_launch(s, plain):
    """On the CPU S <= 512 runs K1's plain version and S > 512 K4's; no
    kernel is launched."""
    port.launch_counts.update(attention=0, flash=0, flash_bwd=0, short=0)
    qkv = torch.from_numpy(_rand(1, s, 3 * 128, seed=s))
    got = port.attention_qkv(qkv, 2)
    assert port.launch_counts == {"attention": 0, "flash": 0, "flash_bwd": 0, "short": 0}
    q, k, v = qkv.chunk(3, dim=-1)
    want = getattr(port, plain)(q, k, v, 2)
    want = want[0] if plain == "flash_reference" else want
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_attention_on_cpu_is_the_plain_version():
    port.launch_counts.update(attention=0, flash=0)
    q = torch.from_numpy(_rand(2, 70, 128, seed=7)).bfloat16()
    k, v = (torch.from_numpy(_rand(2, 90, 128, seed=i)).bfloat16() for i in (8, 9))
    out, lse = port.flash_attention(q, k, v, 2, 80)
    assert port.launch_counts["flash"] == 0
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want_out, want_lse = port.flash_reference(q, k, v, 2, 80)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


def test_flash_reference_masks_padding_keys():
    """Keys at or past seq_len_k change nothing: the result equals attention
    over the live keys alone."""
    q = torch.from_numpy(_rand(1, 40, 128, seed=10))
    k, v = (torch.from_numpy(_rand(1, 64, 128, seed=i)) for i in (11, 12))
    got = port.flash_reference(q, k, v, 2, 50)
    want = port.flash_reference(q, k[:, :50], v[:, :50], 2)
    for a, b in zip(got, want):   # f32 ulps: the products run over 64 keys, not 50
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_flash_reference_chunks_heads_without_changing_the_result(monkeypatch):
    qkv = torch.from_numpy(_rand(2, 600, 3 * 4 * 64, seed=13))
    q, k, v = qkv.chunk(3, dim=-1)
    whole = port.flash_reference(q, k, v, 4)
    monkeypatch.setattr(port, "_PLAIN_CHUNK_ELEMENTS", 2 * 600 * 600)   # one head a chunk
    chunked = port.flash_reference(q, k, v, 4)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fused(device, b, s, h, dtype, seed):
    t = torch.from_numpy(_rand(b, s, 3 * h * 64, seed=seed)).to(device, dtype)
    hd = h * 64
    return t[..., :hd], t[..., hd:2 * hd], t[..., 2 * hd:]


def _assert_held(got, want, dtype):
    """``got`` within CARD_TOL of ``want``, scaled to ``want``."""
    got, want = got.float(), want.float()
    err = got - want
    max_rel = err.abs().max().item() / want.abs().max().item()
    fro_rel = (err.norm() / want.norm()).item()
    max_tol, fro_tol, _ = CARD_TOL[dtype]
    assert max_rel <= max_tol and fro_rel <= fro_tol, (max_rel, fro_rel)


def _check(q, k, v, h, seq_len_k=None):
    with torch.inference_mode():
        before = port.launch_counts["flash"]
        out, lse = port.flash_attention(q, k, v, h, seq_len_k)
        torch.cuda.synchronize()
        assert port.launch_counts["flash"] == before + 1
        want_out, want_lse = port.flash_reference(q, k, v, h, seq_len_k)
    assert out.shape == want_out.shape and out.dtype == q.dtype
    assert lse.shape == want_lse.shape and lse.dtype == torch.float32
    _assert_held(out, want_out, q.dtype)
    lse_err = (lse - want_lse).abs().max().item()
    assert lse_err <= CARD_TOL[q.dtype][2], lse_err


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bf16_region", "f32_1029", "bf16_cross", "bf16_cross_padded",
                                  "bf16_cross_nan"])
def test_k4_matches_plain_on_card(cuda, case):
    """Region shape (1024 px: S = 5334 = 41 x 128 + 86, 24 heads), fused
    layout; f32; and a sequence shard's rectangle (1334 q rows over 5334
    keys, then over 5376 keys of which 5334 are live, the padding random or
    NaN and Inf)."""
    if case == "bf16_region":
        _check(*_fused(cuda, 2, 5334, 24, torch.bfloat16, 0), 24)
    elif case == "f32_1029":
        _check(*_fused(cuda, 1, 1029, 24, torch.float32, 1), 24)
    elif case == "bf16_cross_nan":
        q, k, v = _fused(cuda, 1, 5376, 24, torch.bfloat16, 3)
        k, v = k.clone(), v.clone()
        k[:, 5334:], v[:, 5334:] = float("nan"), float("inf")
        with torch.inference_mode():
            out, lse = port.flash_attention(q[:, :1334], k, v, 24, 5334)
            want_out, want_lse = port.flash_reference(q[:, :1334], k[:, :5334], v[:, :5334], 24)
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        _assert_held(out, want_out, torch.bfloat16)
        assert (lse - want_lse).abs().max().item() <= CARD_TOL[torch.bfloat16][2]
    else:
        q, k, v = _fused(cuda, 1, 5376 if case.endswith("padded") else 5334, 24,
                         torch.bfloat16, 2)
        _check(q[:, :1334], k, v, 24, 5334 if case.endswith("padded") else None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [513, 577, 1301, 2049])
def test_k4_ragged_lengths_on_card(cuda, s, dtype):
    _check(*_fused(cuda, 3, s, 2, dtype, s), 2)


@pytest.mark.gpu
def test_k4_runs_agree_on_card(cuda):
    """The bf16 kernel sums each row in one block, in a fixed order: two runs
    at a region give the same output and lse, bit for bit."""
    q, k, v = _fused(cuda, 2, 5334, 24, torch.bfloat16, 40)
    with torch.inference_mode():
        first = port.flash_attention(q, k, v, 24)
        second = port.flash_attention(q, k, v, 24)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 32, 40])
def test_k4_head_dims_below_64_on_card(cuda, d):
    """Head dims below 64 through K4, zero-padded to 64 with the scale of
    their own D, against the plain version at that D (out and lse)."""
    t = torch.from_numpy(_rand(2, 600, 3 * 3 * d, seed=d)).to(cuda, torch.bfloat16)
    _check(*t.chunk(3, dim=-1), 3)


@pytest.mark.gpu
def test_k4_ignores_nonfinite_padding_keys(cuda):
    q, k, v = _fused(cuda, 1, 700, 2, torch.bfloat16, 20)
    k, v = k.clone(), v.clone()
    k[:, 650:], v[:, 650:] = float("nan"), float("inf")
    with torch.inference_mode():
        out, lse = port.flash_attention(q, k, v, 2, 650)
        want_out, want_lse = port.flash_reference(q, k[:, :650], v[:, :650], 2)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_held(out, want_out, torch.bfloat16)


@pytest.mark.gpu
def test_attention_dispatches_by_length_on_card(cuda):
    for s, kernel in ((512, "attention"), (513, "flash"), (5334, "flash")):
        qkv = torch.from_numpy(_rand(1, s, 3 * 128, seed=s)).to(cuda, torch.bfloat16)
        before = dict(port.launch_counts)
        with torch.inference_mode():
            port.attention_qkv(qkv, 2)
        assert port.launch_counts[kernel] == before[kernel] + 1, (s, kernel)


@pytest.mark.gpu
def test_k4_rejects_what_it_does_not_take(cuda):
    q, k, v = _fused(cuda, 1, 600, 2, torch.float32, 30)
    with pytest.raises(ValueError, match="head dim"):   # 128: above 64
        port.flash_attention(q, k, v, 1)
    with pytest.raises(ValueError, match="bf16 or f32"):
        port.flash_attention(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError, match="launched raw with grad enabled"):
        port._flash_cuda(q.clone().requires_grad_(), k, v, 2, None)
    with pytest.raises(ValueError, match="seq_len_k"):
        port.flash_attention(q, k, v, 2, 601)
    with pytest.raises(ValueError, match="seq_len_k"):
        port.flash_attention(q, k, v, 2, 0)
    with pytest.raises(ValueError, match="Sk, H\\*D"):
        port.flash_attention(q, k[:, :500], v, 2)
    with pytest.raises(ValueError, match="unit stride"):
        port.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 2)
    # q's base 8 bytes off a 16-byte boundary; k and v aligned
    t = torch.zeros((1, 600, 3 * 128 + 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        port.flash_attention(t[..., 4:132], t[..., 136:264], t[..., 264:392], 2)
