"""K3 at decoder widths other than 32 channels (``DetailCapture.fusion_out``
is a config field; C2 = C / 2 gate features a head).

On the card ``fused_seg_heads`` zero-pads C to the next of 16, 32 and 64 and
C2 to the next of 16 and 32 (``pad_seg_heads``) and launches K3's instance
for those widths; above C = 64 it raises. On the CPU: the port's heads at C
16, 48 and 64 against the JAX package's ``fused_seg_heads`` in interpret
mode, the padding exact, the flagship's C = 32 operands left as they are.
The ``gpu`` test holds K3 at those widths against its plain version.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models.mipheivit import BatchedSegHeads
from mipheivit_tpu_torch.ops import seg_heads as port
from test_torch_seg_heads import ATOL, CARD_TOL, RTOL, _nchw, _port_heads

torch.set_num_threads(2)

WIDTHS = (16, 48, 64)
K = 5


def _jax_case(c, seed):
    """JAX BatchedSegHeads variables at C channels and K heads, with
    non-trivial BN statistics and biases, an NHWC input [1, 16, 24, C], and
    the Pallas route's output (``fused_seg_heads`` in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models.mipheivit import BatchedSegHeads as JaxHeads

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16, 24, c)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(lambda key: JaxHeads(K, impl="xla").init(
        key, jnp.asarray(x), train=False))(jax.random.PRNGKey(0)))
    params = dict(variables["params"])
    for name in ("psi_conv1_bias", "psi_conv2_bias", "conv_bias"):
        params[name] = (rng.standard_normal(params[name].shape) * 0.3).astype(np.float32)
    nfeat = K * (c // 2)
    variables = {"params": params, "batch_stats": {"psi_bn": {
        "mean": (rng.standard_normal(nfeat) * 0.3).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, nfeat).astype(np.float32)}}}
    want = np.asarray(JaxHeads(K, impl="pallas_interpret").apply(
        variables, jnp.asarray(x), train=False))
    return variables, x, want


@pytest.mark.parametrize("c", WIDTHS)
def test_widths_match_jax_kernel(c):
    variables, x, want = _jax_case(c, seed=c)
    heads = _port_heads(variables, c, K)
    with torch.inference_mode():
        out = heads(_nchw(x))
    assert out.shape == (1, K, 16, 24) and out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("c", WIDTHS)
def test_padding_is_exact(c):
    """The operands K3 takes at C (padded to 16 or 64 channels and 16 or 32
    gate features a head) give the plain version's output at C."""
    torch.manual_seed(c)
    heads = BatchedSegHeads(c, K).eval()
    with torch.no_grad():
        for p in heads.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
    x = torch.randn(2, c, 16, 16).to(memory_format=torch.channels_last)
    weights = port.fold_heads(heads, torch.float32)
    padded = port.pad_seg_heads(x, *weights)
    cp, c2p = {16: (16, 16), 48: (64, 32), 64: (64, 32)}[c]
    assert padded[0].shape == (2, cp, 16, 16)
    assert padded[0].is_contiguous(memory_format=torch.channels_last)
    assert padded[1].shape == (cp, K * c2p) and padded[3].shape == (K, c2p)
    assert padded[5].shape == (cp, 9 * K)
    torch.testing.assert_close(port.seg_heads_reference(*padded),
                               port.seg_heads_reference(x, *weights), atol=1e-6, rtol=1e-6)


def test_padding_leaves_the_flagship_width_alone():
    """At C = 32, C2 = 16 (every shipped preset) K3 gets the operands
    themselves: the same tensors, bit for bit."""
    heads = BatchedSegHeads(32, 16).eval()
    x = torch.randn(1, 32, 8, 8).to(memory_format=torch.channels_last)
    ops = (x, *port.fold_heads(heads, torch.float32))
    assert all(a is b for a, b in zip(port.pad_seg_heads(*ops), ops))


def test_above_the_widest_raises():
    heads = BatchedSegHeads(80, 3).eval()
    x = torch.randn(1, 80, 8, 8).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="C <= 64"):
        port.pad_seg_heads(x, *port.fold_heads(heads, torch.float32))


# ---------------------------------------------------------------------------
# on the card: K3 at these widths against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,k", [(16, 16), (48, 5), (64, 16), (64, 19)])
def test_widths_on_card(cuda, c, k, dtype):
    torch.manual_seed(c + k)
    heads = BatchedSegHeads(c, k).eval()
    with torch.no_grad():
        for p in heads.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
    heads = heads.to(cuda)
    x = torch.randn(2, c, 72, 136, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    weights = port.fold_heads(heads, dtype)
    before = port.launch_counts["seg_heads"]
    with torch.inference_mode():
        out = port.fused_seg_heads(x, *weights)
        torch.cuda.synchronize()
        want = port.seg_heads_reference(x, *weights)
    assert port.launch_counts["seg_heads"] == before + 1
    assert out.shape == (2, k, 72, 136) and out.dtype == dtype
    err = out.float() - want.float()
    assert err.abs().max() <= CARD_TOL[dtype][0] * want.float().abs().max()
    assert err.norm() <= CARD_TOL[dtype][1] * want.float().norm()
