"""K8 (the fused attention sublayer, ``ln_qkv_attention``) in the PyTorch port
against the JAX package.

On the CPU the port's ``ln_qkv_attention`` runs ``chain_reference``, held
against the JAX kernel ``_ln_qkv_attn_kernel`` run in interpret mode
(``ln_qkv_attention(impl="pallas_interpret")``; the JAX weight is ``[D,
3*H*Dh]``, the port's the ``nn.Linear`` layout ``[3*H*Dh, D]``) and against
the JAX ``_chain_reference``; its gradients against ``jax.grad`` through the
interpreted kernel; and one JAX ViT block's ``norm1`` and ``qkv``
parameters, carried over by ``state_dict_from_jax``, through both packages
and through the port's own block. The ``gpu`` tests hold K8 against the
plain chain on the card; they skip here. Run them on a machine with a card
(tests/conftest.py imports jax, which that machine lacks):

    python -m pytest tests/test_torch_attn_block.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import attn_block as port
from mipheivit_tpu_torch.ops import mlp

torch.set_num_threads(2)

# f32: the same function in another order of summation (the kernel adds the
# bias inside its f32 accumulation and divides after p . v, the chain
# before; in f32 neither rounds)
RTOL = 1e-5
GRAD_RTOL = 1e-4
D, HEADS = 256, 4         # the JAX kernel's gate: D % 128, H*Dh % 128, Dh % 8
# scaled to the reference: (max |err| / max |ref|, ||err|| / ||ref||); in
# bf16 K8 and the chain differ by the bias's rounding and where p is divided
BF16_TOL = (2e-2, 1e-2)
CARD_TOL = {torch.bfloat16: BF16_TOL, torch.float32: (1e-4, 1e-5)}


def _inputs(b, s, seed, d=D, heads=HEADS, dh=64):
    """x [b, s, d], the LayerNorm's scale and bias, the JAX layout's w
    [d, 3*H*dh] and b, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    lns = rng.uniform(0.5, 1.5, d).astype(np.float32)
    lnb = (rng.standard_normal(d) * 0.1).astype(np.float32)
    w = (rng.standard_normal((d, 3 * heads * dh)) / np.sqrt(d)).astype(np.float32)
    bias = (rng.standard_normal(3 * heads * dh) * 0.1).astype(np.float32)
    return x, lns, lnb, w, bias


def _port(x, lns, lnb, w, b):
    return [torch.from_numpy(t) for t in (x, lns, lnb, w.T.copy(), b)]


def _jax(x, lns, lnb, w, b, impl="pallas_interpret", dtype=None):
    import jax.numpy as jnp

    from mipheivit_tpu.ops.attn_block import _chain_reference, ln_qkv_attention

    xj = jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)
    args = (xj, *map(jnp.asarray, (lns, lnb, w, b)))
    if impl == "chain":
        out = _chain_reference(*args, HEADS, 1e-6)
    else:
        out = ln_qkv_attention(*args, HEADS, impl=impl)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("impl", ["pallas_interpret", "chain"])
@pytest.mark.parametrize("s", [37, 128])
def test_matches_jax(s, impl):
    args = _inputs(2, s, seed=s)
    want = _jax(*args, impl=impl)
    got = port.ln_qkv_attention(*_port(*args), HEADS)
    assert got.shape == (2, s, HEADS * 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_bf16_matches_jax_kernel():
    args = _inputs(2, 77, seed=1)
    want = _jax(*args, dtype="bfloat16")
    x, lns, lnb, w, b = _port(*args)
    got = port.ln_qkv_attention(x.bfloat16(), lns, lnb, w, b, HEADS)
    assert got.dtype == torch.bfloat16
    err = got.float().numpy() - want
    assert np.abs(err).max() <= BF16_TOL[0] * np.abs(want).max()
    assert np.linalg.norm(err) <= BF16_TOL[1] * np.linalg.norm(want)


def test_cpu_runs_plain_version_without_launch():
    port.launch_counts["attn_block"] = 0
    args = _port(*_inputs(1, 40, seed=2))
    out = port.ln_qkv_attention(*args, HEADS)
    assert port.launch_counts["attn_block"] == 0
    torch.testing.assert_close(out, port.chain_reference(*args, HEADS), rtol=0, atol=0)


@pytest.mark.parametrize("s,d,heads", [(37, 96, 2), (7, 128, 2), (37, 128, 3)])
def test_outside_the_gate_matches_jax_entry_point(s, d, heads):
    """D = 96, S = 7, or H*Dh = 192, outside the JAX kernel's gate (the JAX
    entry point runs its chain there; the card runs K8): on the CPU the
    port's plain chain against the JAX entry point; forward and
    gradients."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.attn_block import ln_qkv_attention

    args = _inputs(2, s, seed=22 + d + heads, d=d, heads=heads)
    r = np.random.default_rng(23).standard_normal((2, s, heads * 64)).astype(np.float32)
    jargs = [jnp.asarray(t) for t in args]
    want = np.asarray(ln_qkv_attention(*jargs, heads))
    want_grads = jax.grad(lambda *a: jnp.sum(ln_qkv_attention(*a, heads) * r),
                          argnums=tuple(range(5)))(*jargs)
    ts = [t.requires_grad_() for t in _port(*args)]
    got = port.ln_qkv_attention(*ts, heads)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=RTOL)
    grads = [t.grad.numpy() for t in ts]
    grads[3] = grads[3].T                               # [3*H*Dh, D] -> the JAX [D, 3*H*Dh]
    for g, w_ in zip(grads, want_grads):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w_).max())


@pytest.mark.parametrize("shape,want", [
    ((64, 329, 1536, 24, 64), "k8"),                   # ViT-g at 64 tiles
    ((4, 1024, 1536, 24, 64), "k8"),                   # the longest K8 takes
    ((2, 1, 128, 2, 64), "k8"),                        # one token
    ((2, 4, 256, 4, 64), "k8"),
    ((2, 37, 128, 4, 32), "k8"),                       # head dim 32, padded to 64
    ((2, 37, 96, 2, 64), "k8"),                        # D a multiple of 8, not of 128
    ((2, 37, 200, 3, 12), "k8"),
    ((1, 1025, 1536, 24, 64), "k7+attention_qkv"),     # above 1024 tokens
    ((1, 5334, 1536, 24, 64), "k7+attention_qkv"),     # a 1024-px region
    ((1, 1100, 64, 2, 32), "k7+attention_qkv"),
    ((1, 329, 100, 2, 64), "k8"),                      # D not a multiple of 8: padded
    ((2, 37, 4, 1, 8), "k8"),                          # D below 8
    ((1, 1100, 100, 2, 32), "k7+attention_qkv"),
    ((1, 329, 1536, 12, 128), ValueError),             # head dim above 64
    ((1, 329, 1536, 24, 80), ValueError),
    ((0, 329, 1536, 24, 64), ValueError),              # empty
    ((1, 0, 1536, 24, 64), ValueError),
])
def test_route_table(shape, want):
    """The kernels ln_qkv_attention launches on the card by shape: K8 up to
    1024 tokens at any D (padded to a multiple of 8) and any head dim up to
    64; K7 -> attention_qkv (K4) above; a ValueError where no kernel takes
    the shape."""
    if want is ValueError:
        with pytest.raises(ValueError):
            port.route(*shape)
    else:
        assert port.route(*shape) == want


@pytest.mark.parametrize("b,s,d,heads,dh", [(2, 37, 128, 4, 32), (2, 4, 256, 4, 64),
                                            (2, 37, 96, 2, 64), (1, 1100, 64, 2, 32)],
                         ids=["head_dim_32", "s_4", "d_96", "s_1100_k7_route"])
def test_routes_match_jax_entry_point(b, s, d, heads, dh):
    """The shapes the card now serves through K8 (head dim 32, S 4, D 96 with
    2 heads of 64) and through K7 -> attention_qkv (S 1100): on the CPU the
    port (the plain chain up to 1024 tokens; ln_matmul and attention_qkv's
    plain versions above) against the JAX entry point (its chain here);
    forward within 1e-5 of max |ref|, gradients within 1e-4."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.attn_block import ln_qkv_attention

    args = _inputs(b, s, seed=30 + s + dh, d=d, heads=heads, dh=dh)
    r = np.random.default_rng(31).standard_normal((b, s, heads * dh)).astype(np.float32)
    jargs = [jnp.asarray(t) for t in args]
    want = np.asarray(ln_qkv_attention(*jargs, heads))
    want_grads = jax.grad(lambda *a: jnp.sum(ln_qkv_attention(*a, heads) * r),
                          argnums=tuple(range(5)))(*jargs)
    ts = [t.requires_grad_() for t in _port(*args)]
    got = port.ln_qkv_attention(*ts, heads)
    assert got.shape == (b, s, heads * dh)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    grads = [t.grad.numpy() for t in ts]
    grads[3] = grads[3].T                               # [3*H*Dh, D] -> the JAX [D, 3*H*Dh]
    for g, w_ in zip(grads, want_grads):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w_).max())


def test_k7_route_on_cpu_runs_its_entry_points():
    """Above 1024 tokens ln_qkv_attention is ln_matmul then attention_qkv
    (on the CPU their plain versions, no launch)."""
    from mipheivit_tpu_torch.ops.attention import attention_qkv
    from mipheivit_tpu_torch.ops.mlp import ln_matmul

    port.launch_counts["attn_block"] = 0
    x, lns, lnb, w, b = _port(*_inputs(1, 1030, seed=32, d=64, heads=1))
    got = port.ln_qkv_attention(x, lns, lnb, w, b, 1)
    assert port.launch_counts["attn_block"] == 0
    torch.testing.assert_close(got, attention_qkv(ln_matmul(x, lns, lnb, w, b), 1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dh", [12, 32])
def test_padded_route_matches_jax_entry_point(dh):
    """What the card computes for a head dim below 64: the weight rows and
    bias of each head padded to 64 by zeros (``pad_head_rows``), the chain
    at 64 with the scale of the original Dh, each head sliced back; against
    the JAX entry point within 1e-5 of max |ref|, and the padded columns
    exactly 0."""
    import jax.numpy as jnp

    from mipheivit_tpu.ops.attn_block import ln_qkv_attention

    heads, s = 3, 37
    args = _inputs(2, s, seed=33 + dh, d=128, heads=heads, dh=dh)
    want = np.asarray(ln_qkv_attention(*map(jnp.asarray, args), heads))
    x, lns, lnb, w, b = _port(*args)
    wp, bp = port.pad_head_rows(w, b, heads)
    assert wp.shape == (3 * heads * 64, 128) and bp.shape == (3 * heads * 64,)
    out = port.chain_reference(x, lns, lnb, wp, bp, heads, scale=1.0 / np.sqrt(dh))
    out = out.view(2, s, heads, 64)
    assert not out[..., dh:].any()
    got = out[..., :dh].reshape(2, s, heads * dh).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_padded_width_route_matches_jax_entry_point():
    """What the card computes at D 100 with 2 heads of 32: x, the LayerNorm's
    scale and bias and w zero-padded to D 104 (``mlp.pad_ln_matmul``), each
    head's weight rows and bias padded to 64 (``pad_head_rows``), the plain
    chain with the statistics over the true D and the scale of the original
    head dim, each head sliced back; against the JAX entry point (its chain at
    this D): forward within 1e-5 of max |ref|, gradients within 1e-4, and
    the padded columns of the output and of every gradient exactly 0."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.attn_block import ln_qkv_attention

    b, s, d, heads, dh = 2, 37, 100, 2, 32
    args = _inputs(b, s, seed=60, d=d, heads=heads, dh=dh)
    r = np.random.default_rng(61).standard_normal((b, s, heads * dh)).astype(np.float32)
    jargs = [jnp.asarray(t) for t in args]
    want = np.asarray(ln_qkv_attention(*jargs, heads))
    want_grads = jax.grad(lambda *a: jnp.sum(ln_qkv_attention(*a, heads) * r),
                          argnums=tuple(range(5)))(*jargs)
    x, lns, lnb, w, bias = _port(*args)
    w, bias = port.pad_head_rows(w, bias, heads)
    leaves = [t.requires_grad_() for t in mlp.pad_ln_matmul(x, lns, lnb, w, bias)]
    xp, lnsp, lnbp, wp, bp = leaves
    assert xp.shape == (b, s, 104) and wp.shape == (3 * heads * 64, 104)
    out = port.chain_reference(*leaves, heads, scale=1.0 / np.sqrt(dh), width=d)
    out = out.view(b, s, heads, 64)
    assert not out[..., dh:].any()
    got = out[..., :dh].reshape(b, s, heads * dh)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    wg = wp.grad.view(3, heads, 64, 104)
    bg = bp.grad.view(3, heads, 64)
    for pad in (xp.grad[..., d:], lnsp.grad[d:], lnbp.grad[d:], wg[..., d:], wg[:, :, dh:],
                bg[..., dh:]):
        assert not pad.any()
    grads = [xp.grad[..., :d], lnsp.grad[:d], lnbp.grad[:d],
             wg[:, :, :dh, :d].reshape(-1, d).T, bg[..., :dh].reshape(-1)]
    for g, w_ in zip(grads, want_grads):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w_).max())


def test_other_devices_raise():
    x, lns, lnb, w, b = _port(*_inputs(1, 8, seed=3))
    with pytest.raises(ValueError, match="CPU or all on one"):
        port.ln_qkv_attention(x.to("meta"), lns, lnb, w, b, HEADS)
    with pytest.raises(ValueError, match="takes x"):
        port.ln_qkv_attention(x, lns, lnb, w.t(), b, HEADS)


def test_autograd_matches_jax_grad():
    """dx, the LayerNorm's dscale and dbias, dW and db of the port's
    autograd Function against jax.grad through the interpreted kernel
    (whose backward is the vjp of the XLA chain)."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.attn_block import ln_qkv_attention

    args = _inputs(2, 37, seed=4)
    r = np.random.default_rng(5).standard_normal((2, 37, HEADS * 64)).astype(np.float32)

    def loss(*a):
        return jnp.sum(ln_qkv_attention(*a, HEADS, impl="pallas_interpret") * r)

    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    ts = [t.requires_grad_() for t in _port(*args)]
    (port.ln_qkv_attention(*ts, HEADS) * torch.from_numpy(r)).sum().backward()
    got = [t.grad.numpy() for t in ts]
    got[3] = got[3].T                                 # [3HD, D] -> the JAX [D, 3HD]
    for g, w_ in zip(got, map(np.asarray, want)):
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w_).max())


def test_jax_block_weights_through_both_packages():
    """One JAX ViT block's norm1 and qkv parameters, carried over by
    state_dict_from_jax: the JAX kernel (interpreted) and K7 + attention
    in JAX against ln_qkv_attention and ln_matmul + attention_qkv in the
    port, and against the port's own block (norm1 -> qkv -> attention)."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu.models import VisionTransformer as JaxVisionTransformer
    from mipheivit_tpu.ops.attention import attention_qkv as jax_attention_qkv
    from mipheivit_tpu.ops.attn_block import ln_qkv_attention as jax_ln_qkv_attention
    from mipheivit_tpu.ops.mlp import ln_matmul as jax_ln_matmul
    from mipheivit_tpu_torch.models import ViTConfig, VisionTransformer
    from mipheivit_tpu_torch.models.convert import state_dict_from_jax
    from mipheivit_tpu_torch.ops.attention import attention_qkv
    from mipheivit_tpu_torch.ops.mlp import ln_matmul

    geom = dict(img_size=(32, 32), patch_size=4, embed_dim=D, depth=1, num_heads=HEADS,
                mlp_hidden_dim=512, reg_tokens=4)
    cfg = JaxViTConfig(**geom, remat=False)
    params = jax.tree.map(np.asarray, jax.jit(JaxVisionTransformer(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    rng = np.random.default_rng(6)
    blk = params["blocks"]
    blk["norm1"]["scale"] = rng.uniform(0.5, 1.5, blk["norm1"]["scale"].shape).astype(np.float32)
    blk["norm1"]["bias"] = (rng.standard_normal(blk["norm1"]["bias"].shape) * 0.1).astype(np.float32)
    blk["attn"]["qkv"]["bias"] = (rng.standard_normal(blk["attn"]["qkv"]["bias"].shape)
                                  * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 69, D)).astype(np.float32)
    lns, lnb = blk["norm1"]["scale"][0], blk["norm1"]["bias"][0]
    wq, bq = blk["attn"]["qkv"]["kernel"][0], blk["attn"]["qkv"]["bias"][0]
    jargs = [jnp.asarray(t) for t in (x, lns, lnb, wq, bq)]
    want = np.asarray(jax_ln_qkv_attention(*jargs, HEADS, impl="pallas_interpret"))
    want7 = np.asarray(jax_attention_qkv(jax_ln_matmul(*jargs, impl="pallas_interpret"), HEADS,
                                         impl="flash_interpret"))

    vit = VisionTransformer(ViTConfig(**geom)).eval()
    state = state_dict_from_jax({"params": params}, cfg)
    vit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    block = vit.blocks[0]
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        ours = [port.ln_qkv_attention(xt, block.norm1.weight, block.norm1.bias,
                                      block.attn.qkv.weight, block.attn.qkv.bias, HEADS),
                attention_qkv(ln_matmul(xt, block.norm1.weight, block.norm1.bias,
                                        block.attn.qkv.weight, block.attn.qkv.bias), HEADS),
                attention_qkv(block.attn.qkv(block.norm1(xt)), HEADS)]
    tol = dict(rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(want7, want, **tol)
    for got in ours:
        np.testing.assert_allclose(got.numpy(), want, **tol)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(b, s, d, heads, dtype, device, seed, dh=64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, d), generator=g).to(device, dtype)
    lns = (torch.rand(d, generator=g) + 0.5).to(device)
    lnb = (torch.randn(d, generator=g) * 0.1).to(device)
    w = (torch.randn((3 * heads * dh, d), generator=g) / d ** 0.5).to(device, dtype)
    bias = (torch.randn(3 * heads * dh, generator=g) * 0.1).to(device, dtype)
    return x, lns, lnb, w, bias


def _scaled(got, want):
    err = got.float() - want.float()
    return ((err.abs().max() / want.float().abs().max()).item(),
            (err.norm() / want.float().norm()).item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,d,heads,dh", [
    (4, 329, 1536, 24, 64), (2, 1024, 256, 4, 64), (3, 8, 128, 2, 64), (2, 65, 256, 2, 64),
    (1, 200, 384, 6, 64), (1, 700, 256, 4, 64),
    # ragged S: one token, a part tile, a tile and one, past one and two
    # clusters' blocks
    (2, 1, 128, 2, 64), (2, 7, 128, 2, 64), (2, 63, 256, 2, 64), (2, 513, 256, 4, 64),
    (1, 1000, 256, 2, 64),
    # D a multiple of 8 only; head dims below 64
    (2, 329, 96, 2, 64), (2, 329, 200, 3, 64), (2, 329, 256, 4, 12), (2, 329, 256, 8, 32),
    # D not a multiple of 8, or below 8: zero-padded
    (2, 329, 100, 2, 32), (2, 37, 4, 1, 8)])
def test_kernel_matches_plain_on_card(cuda, b, s, d, heads, dh, dtype):
    """K8 against the plain chain, one launch, up to 1024 tokens at any D
    (not a multiple of 8: padded) and head dims up to 64 (below it
    padded)."""
    args = _card_inputs(b, s, d, heads, dtype, cuda, seed=s + d + dh, dh=dh)
    port.launch_counts["attn_block"] = 0
    with torch.inference_mode():
        got = port.ln_qkv_attention(*args, heads)
        want = port.chain_reference(*args, heads)
        torch.cuda.synchronize()
    assert port.launch_counts["attn_block"] == 1
    assert got.shape == (b, s, heads * dh) and got.dtype == dtype
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1536, 100])
def test_kernel_takes_unaligned_ln_params_on_card(cuda, d):
    """The LayerNorm's scale and bias as views at an odd element offset of a
    packed buffer: K8 reads them from an aligned copy, one launch, against
    the plain chain."""
    heads = 24 if d == 1536 else 2
    x, lns, lnb, w, b = _card_inputs(2, 329, d, heads, torch.bfloat16, cuda, seed=d + 13,
                                     dh=64 if d == 1536 else 32)
    packed = torch.empty(2 * d + 1, device=cuda)
    packed[1:d + 1], packed[d + 1:] = lns, lnb
    lns, lnb = packed[1:d + 1], packed[d + 1:]
    assert lns.data_ptr() % 8
    port.launch_counts["attn_block"] = 0
    with torch.inference_mode():
        got = port.ln_qkv_attention(x, lns, lnb, w, b, heads)
        want = port.chain_reference(x, lns, lnb, w, b, heads)
        torch.cuda.synchronize()
    assert port.launch_counts["attn_block"] == 1
    rel, fro = _scaled(got, want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


@pytest.mark.gpu
def test_kernel_reads_strided_rows_on_card(cuda):
    """x as a column slice of a wider buffer (row stride 2D)."""
    x, lns, lnb, w, b = _card_inputs(2, 329, 512, 4, torch.bfloat16, cuda, seed=7)
    xs = x[..., :256]
    with torch.inference_mode():
        got = port.ln_qkv_attention(xs, lns[:256], lnb[:256], w[:, :256].contiguous(), b, 4)
        want = port.chain_reference(xs, lns[:256], lnb[:256], w[:, :256], b, 4)
        torch.cuda.synchronize()
    rel, fro = _scaled(got, want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


@pytest.mark.gpu
def test_backward_on_card_matches_cpu(cuda):
    """f32: K8 forward and the chain's backward on the card against the CPU."""
    args = _card_inputs(2, 50, 128, 2, torch.float32, torch.device("cpu"), seed=8)
    r = torch.randn((2, 50, 128), generator=torch.Generator().manual_seed(9))
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_() for t in args]
        (port.ln_qkv_attention(*ts, 2) * r.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1100, 1280])
def test_long_sequences_go_to_k7_and_k4_on_card(cuda, s):
    """Above 1024 tokens: ln_matmul (K7) then attention_qkv (K4), one launch
    each, against the plain chain."""
    from mipheivit_tpu_torch.ops import attention

    args = _card_inputs(1, s, 256, 4, torch.bfloat16, cuda, seed=s)
    for counts in (port.launch_counts, attention.launch_counts, mlp.launch_counts):
        for key in counts:
            counts[key] = 0
    with torch.inference_mode():
        got = port.ln_qkv_attention(*args, 4)
        want = port.chain_reference(*args, 4)
        torch.cuda.synchronize()
    assert port.launch_counts["attn_block"] == 0
    assert mlp.launch_counts["ln_matmul"] == 1 and attention.launch_counts["flash"] == 1
    assert sum(attention.launch_counts.values()) == 1
    rel, fro = _scaled(got, want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


@pytest.mark.gpu
def test_long_sequence_at_d_100_on_card(cuda):
    """Above 1024 tokens at D 100 (2 heads of 32): ln_matmul (K7, K and N
    padded) then attention_qkv (K4), one launch each, against the plain
    chain."""
    from mipheivit_tpu_torch.ops import attention

    args = _card_inputs(1, 1100, 100, 2, torch.bfloat16, cuda, seed=12, dh=32)
    for counts in (port.launch_counts, attention.launch_counts, mlp.launch_counts):
        for key in counts:
            counts[key] = 0
    with torch.inference_mode():
        got = port.ln_qkv_attention(*args, 2)
        want = port.chain_reference(*args, 2)
        torch.cuda.synchronize()
    assert got.shape == (1, 1100, 64) and port.launch_counts["attn_block"] == 0
    assert mlp.launch_counts["ln_matmul"] == 1 and attention.launch_counts["flash"] == 1
    rel, fro = _scaled(got, want)
    assert rel <= BF16_TOL[0] and fro <= BF16_TOL[1], (rel, fro)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    """What still raises on the card: head dims above 64, other dtypes, a
    raw launch with grad enabled (D not a multiple of 8 is served, padded:
    test_kernel_matches_plain_on_card)."""
    x, lns, lnb, w, b = _card_inputs(1, 40, 256, 4, torch.bfloat16, cuda, seed=10)
    launches = dict(port.launch_counts)
    with pytest.raises(ValueError, match="head dim"):               # 2 heads of 128
        port.ln_qkv_attention(x, lns, lnb, w, b, 2)
    assert port.launch_counts == launches
    with pytest.raises(ValueError, match="one dtype"):
        port._attn_block_cuda(x.half(), lns, lnb, w.half(), b.half(), 4, 1e-6)
    with pytest.raises(ValueError, match="grad enabled"):
        port._attn_block_cuda(x.requires_grad_(), lns, lnb, w, b, 4, 1e-6)


@pytest.mark.gpu
def test_failed_launch_raises(cuda):
    """A launch the card refuses (a grid deeper than 65535 batch items)
    surfaces as an error, and counts no launch."""
    x, lns, lnb, w, b = _card_inputs(1, 8, 128, 2, torch.bfloat16, cuda, seed=11)
    port.launch_counts["attn_block"] = 0
    with torch.inference_mode(), pytest.raises(RuntimeError, match="K8 attention block launch"):
        port.ln_qkv_attention(x.expand(65536, 8, 128).contiguous(), lns, lnb, w, b, 2)
    assert port.launch_counts["attn_block"] == 0
