"""K2 (fused SwiGLU fc1) in the PyTorch port against the JAX package.

On the CPU the port runs K2's plain version, ``swiglu_reference``, which is
held against the JAX kernel ``_swiglu_kernel`` run in interpret mode
(``swiglu_fc1(impl="pallas_interpret")``), with and without the LayerNorm
prologue, on ragged row counts; the port's autograd Function against
``jax.grad`` through the interpreted kernel (its elementwise terms,
``swiglu_bwd_reference`` on the CPU, with them); and a ViT's MLP against the
JAX ``Mlp`` with ``mlp_impl="pallas_interpret"``. The ``gpu`` tests hold the
CUDA kernel against the plain version on the card; they skip here. Run them
on a machine with a card (tests/conftest.py imports jax, which that machine
lacks):

    python -m pytest tests/test_torch_mlp.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops import mlp as port

torch.set_num_threads(2)

# f32 on the CPU: the same products and epilogue in another summation order
ATOL = RTOL = 1e-5
GRAD_RTOL = 1e-4
K, H = 128, 256
# K2 against its plain version on the card, scaled to the reference: (max
# |err| / max |ref|, ||err|| / ||ref||); both accumulate in f32 and round
# once, so bf16 differs by about one output rounding
CARD_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-5)}


def _inputs(m, seed=0, ln=False):
    """x [m, K], the JAX layout's packed kernel [K, 2H] and bias [2H], and
    the LayerNorm's scale and bias, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    w = (rng.standard_normal((K, 2 * H)) / np.sqrt(K)).astype(np.float32)
    b = (rng.standard_normal(2 * H) * 0.1).astype(np.float32)
    lns = rng.uniform(0.5, 1.5, K).astype(np.float32) if ln else None
    lnb = (rng.standard_normal(K) * 0.1).astype(np.float32) if ln else None
    return x, w, b, lns, lnb


def _jax_fc1(x, w, b, lns, lnb):
    import jax.numpy as jnp

    from mipheivit_tpu.ops.mlp import swiglu_fc1

    ln = None if lns is None else (jnp.asarray(lns), jnp.asarray(lnb))
    return np.asarray(swiglu_fc1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), ln=ln,
                                 impl="pallas_interpret"))


def _port_ln(lns, lnb):
    return None if lns is None else (torch.from_numpy(lns), torch.from_numpy(lnb))


@pytest.mark.parametrize("ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("m", [74, 329])
def test_reference_matches_jax_kernel(m, ln):
    x, w, b, lns, lnb = _inputs(m, seed=m, ln=ln)
    want = _jax_fc1(x, w, b, lns, lnb)
    got = port.swiglu_reference(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                torch.from_numpy(b), _port_ln(lns, lnb))
    assert got.shape == (m, H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_runs_plain_version_without_launch():
    port.launch_counts["swiglu"] = 0
    x, w, b, _, _ = _inputs(2 * 37, seed=1)
    xt = torch.from_numpy(x).reshape(2, 37, K)
    wt, bt = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    out = port.swiglu_fc1(xt, wt, bt)
    assert out.shape == (2, 37, H)
    assert port.launch_counts["swiglu"] == 0
    torch.testing.assert_close(out.reshape(-1, H), port.swiglu_reference(xt.reshape(-1, K), wt, bt),
                               rtol=0, atol=0)


def test_reference_rounds_once_in_bf16():
    """bf16 inputs: f32 products and epilogue, one rounding (not the chain
    that rounds fc1's output before the gate)."""
    x, w, b, _, _ = _inputs(50, seed=2)
    xb, wb, bb = (torch.from_numpy(t).bfloat16() for t in (x, w.T.copy(), b))
    got = port.swiglu_reference(xb, wb, bb)
    a = xb.float() @ wb[:H].float().t() + bb[:H].float()
    g = xb.float() @ wb[H:].float().t() + bb[H:].float()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, (a * torch.sigmoid(a) * g).bfloat16(), rtol=0, atol=0)


def test_kernel_ln_params_are_aligned_f32():
    """What the kernels read of the LayerNorm's scale and bias: an aligned
    contiguous f32 tensor of a width that is a multiple of 64 comes back as
    it is; one at an odd element offset or with a stride is copied to an
    aligned base (the bf16 kernels read float2 pairs); another width is
    zero-padded to the next multiple of 64; values are kept."""
    base = torch.arange(257, dtype=torch.float32)
    whole = base[:128].clone()
    for got, want in zip(port.kernel_ln_params(whole, whole), (whole, whole)):
        assert got.data_ptr() == want.data_ptr()
    for view in (base[1:129], base[:256:2]):
        assert view.data_ptr() % 8 or not view.is_contiguous()
        for got in port.kernel_ln_params(view, view):
            assert got.is_contiguous() and got.data_ptr() % 8 == 0
            torch.testing.assert_close(got, view, rtol=0, atol=0)
    bf = torch.randn(100).bfloat16()
    for got in port.kernel_ln_params(bf, bf):
        assert got.dtype == torch.float32 and got.shape == (128,) and got.data_ptr() % 8 == 0
        torch.testing.assert_close(got[:100], bf.float(), rtol=0, atol=0)
        assert not got[100:].any()


def test_other_devices_raise():
    x = torch.empty((4, K), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one"):
        port.swiglu_fc1(x, torch.empty((2 * H, K)), torch.empty(2 * H))


def _jax_grads(x, w, b, lns, lnb, r):
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.mlp import swiglu_fc1

    def loss(*args):
        ln = None if lns is None else args[3:]
        out = swiglu_fc1(args[0], args[1], args[2], ln=ln, impl="pallas_interpret")
        return jnp.sum(out * r)

    args = [jnp.asarray(t) for t in (x, w, b, lns, lnb) if t is not None]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(args))))(*args)]


@pytest.mark.parametrize("ln", [False, True], ids=["plain", "ln"])
def test_autograd_matches_jax_grad(ln):
    """dx, dW, db (and the LayerNorm's dscale, dbias) of the port's
    autograd Function against jax.grad through the interpreted kernel."""
    x, w, b, lns, lnb = _inputs(74, seed=3, ln=ln)
    r = np.random.default_rng(4).standard_normal((74, H)).astype(np.float32)
    want = _jax_grads(x, w, b, lns, lnb, r)
    ts = [torch.from_numpy(t.copy()).requires_grad_() for t in (x, w.T.copy(), b, lns, lnb)
          if t is not None]
    out = port.swiglu_fc1(ts[0], ts[1], ts[2], ln=None if not ln else (ts[3], ts[4]))
    (out * torch.from_numpy(r)).sum().backward()
    got = [t.grad.numpy() for t in ts]
    got[1] = got[1].T                                    # [2H, K] -> the JAX [K, 2H]
    assert len(got) == len(want) == (5 if ln else 3)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w_).max())


@pytest.mark.parametrize("ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("k,h", [(100, 100), (36, 4)])
def test_padded_route_matches_jax_entry_point(k, h, ln):
    """What the card computes for K or H not a multiple of 8 (or H below 8):
    the operands zero-padded by ``pad_swiglu`` (zero columns of x, of W and
    of the LayerNorm's scale and bias; each half of the packed W padded to
    ``padded_width(H)`` rows on its own, with zero bias), the plain version
    with the statistics over the true K, sliced back; against the JAX entry
    point (its plain chain at these widths): forward within 1e-5 of max
    |ref|, gradients within 1e-4, and the padded columns of the output and
    of every gradient exactly 0."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.mlp import swiglu_fc1

    kp, hp = port.padded_width(k), port.padded_width(h)
    rng = np.random.default_rng(50 + k + h)
    x = rng.standard_normal((37, k)).astype(np.float32)
    w = (rng.standard_normal((k, 2 * h)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal(2 * h) * 0.1).astype(np.float32)
    lns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    lnb = (rng.standard_normal(k) * 0.1).astype(np.float32)
    r = rng.standard_normal((37, h)).astype(np.float32)
    jargs = [jnp.asarray(t) for t in ((x, w, b, lns, lnb) if ln else (x, w, b))]

    def jax_fc1(*a):
        return swiglu_fc1(a[0], a[1], a[2], ln=a[3:] if ln else None)

    want = np.asarray(jax_fc1(*jargs))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_fc1(*a) * r),
                          argnums=tuple(range(len(jargs))))(*jargs)
    xp, wp, bp, lnp = port.pad_swiglu(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                      torch.from_numpy(b), _port_ln(lns, lnb) if ln else None)
    leaves = [t.requires_grad_() for t in (xp, wp, bp, *(lnp or ()))]
    assert xp.shape == (37, kp) and wp.shape == (2 * hp, kp) and bp.shape == (2 * hp,)
    out = port.swiglu_reference(xp, wp, bp, lnp, width=k)
    assert out.shape == (37, hp) and not out[:, h:].any()
    (out[:, :h] * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out[:, :h].detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    halves = [slice(0, h), slice(hp, hp + h)]           # the value and gate rows of the padding
    pads = [xp.grad[:, k:], wp.grad[:, k:], wp.grad[h:hp], wp.grad[hp + h:], bp.grad[h:hp],
            bp.grad[hp + h:]] + [t.grad[k:] for t in leaves[3:]]
    for pad in pads:
        assert not pad.any()
    grads = [xp.grad[:, :k], torch.cat([wp.grad[sl, :k] for sl in halves]).T,
             torch.cat([bp.grad[sl] for sl in halves])] + [t.grad[:k] for t in leaves[3:]]
    assert len(grads) == len(want_grads)
    for g, w_ in zip(grads, want_grads):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w_).max())


def test_backward_computes_only_what_is_needed():
    """A frozen fc1 (weights without grad) gets dx alone, equal to autograd
    through the plain version."""
    x, w, b, _, _ = _inputs(40, seed=5)
    xt = torch.from_numpy(x).requires_grad_()
    wt, bt = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    r = torch.from_numpy(np.random.default_rng(6).standard_normal((40, H)).astype(np.float32))
    (port.swiglu_fc1(xt, wt, bt) * r).sum().backward()
    assert wt.grad is None and bt.grad is None
    xr = torch.from_numpy(x).requires_grad_()
    (port.swiglu_reference(xr, wt, bt) * r).sum().backward()
    torch.testing.assert_close(xt.grad, xr.grad, rtol=1e-5, atol=1e-6)


def test_backward_terms_on_cpu_are_the_plain_version():
    """The backward's elementwise terms on the CPU: the plain version, no
    launch; in bf16 f32 terms rounded once."""
    rng = np.random.default_rng(8)
    ag = torch.from_numpy(rng.standard_normal((37, 2 * H)).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((37, H)).astype(np.float32))
    port.launch_counts["swiglu_bwd"] = 0
    got = port.swiglu_gate_grad(ag, dh)
    assert port.launch_counts["swiglu_bwd"] == 0
    torch.testing.assert_close(got, port.swiglu_bwd_reference(ag, dh), rtol=0, atol=0)
    a, g = ag[:, :H].double(), ag[:, H:].double()
    s = torch.sigmoid(a)
    want = torch.cat([dh.double() * g * (s + a * s * (1 - s)), dh.double() * a * s], -1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    agb, dhb = ag.bfloat16(), dh.bfloat16()
    gotb = port.swiglu_bwd_reference(agb, dhb)
    assert gotb.dtype == torch.bfloat16
    torch.testing.assert_close(gotb, port.swiglu_bwd_reference(agb.float(), dhb.float()).bfloat16(),
                               rtol=0, atol=0)


GEOM = dict(img_size=(32, 32), patch_size=4, embed_dim=K, depth=2, num_heads=2,
            mlp_hidden_dim=H, reg_tokens=4)


def test_mlp_and_vit_match_jax_pallas_route():
    """A depth-2, width-128 ViT with the JAX MLP on its Pallas route
    (interpret mode): the port's Mlp module and the whole ViT."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu.models import VisionTransformer as JaxVisionTransformer
    from mipheivit_tpu.models.vit import Mlp as JaxMlp
    from mipheivit_tpu_torch.models import ViTConfig, VisionTransformer
    from mipheivit_tpu_torch.models.convert import state_dict_from_jax
    from mipheivit_tpu_torch.models.vit import Mlp

    cfg = JaxViTConfig(**GEOM, attn_impl="flash_interpret", mlp_impl="pallas_interpret",
                       remat=False)
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((2, 69, K)).astype(np.float32)
    jmlp = JaxMlp(cfg)
    mparams = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(1), jnp.asarray(tokens)))
    mparams["params"]["fc1"]["bias"] = (rng.standard_normal(2 * H) * 0.1).astype(np.float32)
    want_mlp = np.asarray(jmlp.apply(mparams, jnp.asarray(tokens)))
    mlp = Mlp(ViTConfig(**GEOM))
    p = mparams["params"]
    mlp.load_state_dict({"fc1.weight": torch.from_numpy(p["fc1"]["kernel"].T.copy()),
                         "fc1.bias": torch.from_numpy(p["fc1"]["bias"].copy()),
                         "fc2.weight": torch.from_numpy(p["fc2"]["kernel"].T.copy()),
                         "fc2.bias": torch.from_numpy(p["fc2"]["bias"].copy())})
    with torch.inference_mode():
        got_mlp = mlp(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got_mlp, want_mlp, atol=ATOL, rtol=RTOL)

    jvit = JaxVisionTransformer(cfg)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jvit.init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"])
    blocks = params["blocks"]
    for name in ("ls1", "ls2"):     # layerscale at a trained magnitude
        blocks[name] = rng.uniform(0.05, 0.15, blocks[name].shape).astype(np.float32)
    want = np.asarray(jax.jit(jvit.apply)({"params": params}, jnp.asarray(x)))
    vit = VisionTransformer(ViTConfig(**GEOM)).eval()
    state = state_dict_from_jax({"params": params}, cfg)
    vit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    with torch.inference_mode():
        got = vit(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(m, k, h, dtype, device, seed, ln=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(device, dtype)
    w = (torch.randn((2 * h, k), generator=g) / k ** 0.5).to(device, dtype)
    b = (torch.randn(2 * h, generator=g) * 0.1).to(device, dtype)
    lnp = None
    if ln:
        lnp = ((torch.rand(k, generator=g) + 0.5).to(device),
               (torch.randn(k, generator=g) * 0.1).to(device))
    return x, w, b, lnp


def _scaled(got, want):
    err = (got.float() - want.float())
    return ((err.abs().max() / want.float().abs().max()).item(),
            (err.norm() / want.float().norm()).item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("m,k,h", [(658, 1536, 4096), (329, 136, 264), (1, 64, 8)])
def test_kernel_matches_plain_on_card(cuda, m, k, h, ln, dtype):
    x, w, b, lnp = _card_inputs(m, k, h, dtype, cuda, seed=m + k, ln=ln)
    port.launch_counts["swiglu"] = 0
    with torch.inference_mode():
        got = port.swiglu_fc1(x, w, b, ln=lnp)
        want = port.swiglu_reference(x, w, b, lnp)
        torch.cuda.synchronize()
    assert port.launch_counts["swiglu"] == 1
    assert got.dtype == dtype and got.shape == (m, h)
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,h", [(21056, 1536, 4096), (10528, 1536, 4096), (5334, 1536, 4096),
                                   (2632, 1536, 4096), (658, 1536, 4096), (1, 1536, 4096),
                                   (330, 200, 520)])
def test_k2_at_path_shapes_on_card(cuda, m, k, h):
    """The bf16 kernel without LayerNorm (the persistent warp-specialised
    one) at every path's fc1 (64 tiles, the daemon's 32, a 1024-px region,
    a 256-px training microbatch of 8), ragged rows, one row, and H and K
    tails, against the plain version scaled to the reference."""
    x, w, b, _ = _card_inputs(m, k, h, torch.bfloat16, cuda, seed=m + h)
    port.launch_counts["swiglu"] = 0
    with torch.inference_mode():
        got = port.swiglu_fc1(x, w, b)
        want = port.swiglu_reference(x, w, b)
        torch.cuda.synchronize()
    assert port.launch_counts["swiglu"] == 1
    assert got.shape == (m, h) and torch.isfinite(got).all()
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[torch.bfloat16][0] and fro <= CARD_TOL[torch.bfloat16][1], (rel, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,h", [(21056, 1536, 4096), (10528, 1536, 4096), (5334, 1536, 4096),
                                   (658, 1536, 4096), (329, 1536, 4096), (1, 1536, 4096),
                                   (329, 192, 200), (330, 200, 520)])
def test_k2_ln_at_path_shapes_on_card(cuda, m, k, h):
    """The bf16 LayerNorm variant (the persistent warp-specialised kernel
    with the LayerNorm applied to its A fragments in registers) at ViT-g's
    fc1 widths for the row counts of 64 tiles, the daemon's 32, a 1024-px
    region, two tiles, one tile and one row, and at ragged H and K, against
    the plain version scaled to the reference."""
    x, w, b, lnp = _card_inputs(m, k, h, torch.bfloat16, cuda, seed=m + k + h, ln=True)
    port.launch_counts["swiglu"] = 0
    with torch.inference_mode():
        got = port.swiglu_fc1(x, w, b, ln=lnp)
        want = port.swiglu_reference(x, w, b, lnp)
        torch.cuda.synchronize()
    assert port.launch_counts["swiglu"] == 1
    assert got.shape == (m, h) and torch.isfinite(got).all()
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[torch.bfloat16][0] and fro <= CARD_TOL[torch.bfloat16][1], (rel, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("m,k,h", [(329, 100, 100), (37, 36, 4), (658, 100, 4096),
                                   (5, 1, 3)])
def test_padded_route_on_card(cuda, m, k, h, ln, dtype):
    """K or H not a multiple of 8 (or H below 8): the entry point zero-pads
    the operands (each half of the packed weight on its own) and slices the
    output back; one launch, against the plain version on the unpadded
    operands."""
    x, w, b, lnp = _card_inputs(m, k, h, dtype, cuda, seed=m + k + h, ln=ln)
    port.launch_counts["swiglu"] = 0
    with torch.inference_mode():
        got = port.swiglu_fc1(x, w, b, ln=lnp)
        want = port.swiglu_reference(x, w, b, lnp)
        torch.cuda.synchronize()
    assert port.launch_counts["swiglu"] == 1
    assert got.shape == (m, h) and got.dtype == dtype
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
def test_ln_variant_reads_strided_rows_on_card(cuda):
    """The LayerNorm variant on x as every other row of a buffer (row stride
    2K) and on a 3-D input."""
    x, w, b, lnp = _card_inputs(2 * 200, 256, 200, torch.bfloat16, cuda, seed=10, ln=True)
    with torch.inference_mode():
        got = port.swiglu_fc1(x[::2], w, b, ln=lnp)
        want = port.swiglu_reference(x[::2], w, b, lnp)
        got3 = port.swiglu_fc1(x.reshape(4, 100, 256), w, b, ln=lnp)
        torch.cuda.synchronize()
    assert got3.shape == (4, 100, 200)
    assert max(_scaled(got, want)) <= 1e-2
    assert max(_scaled(got3.reshape(-1, 200), port.swiglu_reference(x, w, b, lnp))) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1536, 100])
def test_ln_variant_takes_unaligned_ln_params_on_card(cuda, k):
    """The LayerNorm's scale and bias as views at an odd element offset of a
    packed buffer: the kernel reads them from an aligned copy, one launch,
    against the plain version."""
    x, w, b, (lns, lnb) = _card_inputs(329, k, 264, torch.bfloat16, cuda, seed=k + 11, ln=True)
    packed = torch.empty(2 * k + 1, device=cuda)
    packed[1:k + 1], packed[k + 1:] = lns, lnb
    lnp = (packed[1:k + 1], packed[k + 1:])
    assert lnp[0].data_ptr() % 8
    port.launch_counts["swiglu"] = 0
    with torch.inference_mode():
        got = port.swiglu_fc1(x, w, b, ln=lnp)
        want = port.swiglu_reference(x, w, b, lnp)
        torch.cuda.synchronize()
    assert port.launch_counts["swiglu"] == 1
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[torch.bfloat16][0] and fro <= CARD_TOL[torch.bfloat16][1], (rel, fro)


@pytest.mark.gpu
def test_kernel_reads_strided_rows_on_card(cuda):
    """x as every other row of a buffer (row stride 2K) and a 3-D input."""
    x, w, b, _ = _card_inputs(2 * 200, 256, 128, torch.bfloat16, cuda, seed=9)
    with torch.inference_mode():
        got = port.swiglu_fc1(x[::2], w, b)
        want = port.swiglu_reference(x[::2], w, b)
        got3 = port.swiglu_fc1(x.reshape(4, 100, 256), w, b)
        torch.cuda.synchronize()
    assert got3.shape == (4, 100, 128)
    assert max(_scaled(got, want)) <= 1e-2
    assert max(_scaled(got3.reshape(-1, 128), port.swiglu_reference(x, w, b))) <= 1e-2


@pytest.mark.gpu
def test_backward_on_card_matches_cpu(cuda):
    """f32: the card's backward (cuBLAS recompute) against the CPU's."""
    x, w, b, _ = _card_inputs(96, 64, 32, torch.float32, torch.device("cpu"), seed=11)
    r = torch.randn((96, 32), generator=torch.Generator().manual_seed(12))
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_() for t in (x, w, b)]
        (port.swiglu_fc1(*ts) * r.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,h", [(658, 4096), (3, 8)])
def test_backward_terms_match_plain_on_card(cuda, m, h, dtype):
    g = torch.Generator().manual_seed(m + h)
    ag = torch.randn((m, 2 * h), generator=g).to(cuda, dtype)
    dh = torch.randn((m, h), generator=g).to(cuda, dtype)
    port.launch_counts["swiglu_bwd"] = 0
    got = port.swiglu_gate_grad(ag, dh)
    want = port.swiglu_bwd_reference(ag, dh)
    # an output gradient that is a broadcast view (the gradient of a sum)
    ones = torch.ones((), device=cuda, dtype=dtype).expand(m, h)
    got1 = port.swiglu_gate_grad(ag, ones)
    torch.cuda.synchronize()
    assert port.launch_counts["swiglu_bwd"] == 2
    assert got.dtype == dtype and got.shape == (m, 2 * h)
    for a, b in ((got, want), (got1, port.swiglu_bwd_reference(ag, ones))):
        rel, fro = _scaled(a, b)
        assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
def test_bf16_backward_launches_backward_terms(cuda):
    """The bf16 backward on the card forms its elementwise terms in K2's
    backward entry point, once per call; dx agrees with autograd through
    the plain version."""
    x, w, b, _ = _card_inputs(329, 256, 128, torch.bfloat16, cuda, seed=14)
    r = torch.randn((329, 128), generator=torch.Generator().manual_seed(15)).to(cuda,
                                                                                 torch.bfloat16)
    xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    port.launch_counts["swiglu_bwd"] = 0
    (port.swiglu_fc1(xk, w, b).float() * r.float()).sum().backward()
    assert port.launch_counts["swiglu_bwd"] == 1
    (port.swiglu_reference(xr, w, b).float() * r.float()).sum().backward()
    assert max(_scaled(xk.grad, xr.grad)) <= 2e-2


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w, b, _ = _card_inputs(16, 64, 16, torch.bfloat16, cuda, seed=13)
    with pytest.raises(ValueError, match="grad enabled"):
        port._swiglu_cuda(x.requires_grad_(), w, b, None, 1e-6)
    with pytest.raises(ValueError, match="one dtype"):
        port._swiglu_cuda(x.detach().half(), w.half(), b.half(), None, 1e-6)
    with pytest.raises(ValueError, match="multiples of 8"):
        port._swiglu_cuda(x.detach()[:, :60], w[:, :60].contiguous(), b, None, 1e-6)
    with pytest.raises(ValueError, match="one dtype"):
        port._gate_bwd_cuda(torch.zeros((4, 32), device=cuda), torch.zeros(
            (4, 16), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 8"):
        port._gate_bwd_cuda(torch.zeros((4, 24), device=cuda), torch.zeros((4, 12), device=cuda))


@pytest.mark.gpu
def test_failed_launch_raises(cuda):
    """A launch the card refuses surfaces as an error, and counts no launch,
    with and without the LayerNorm: the persistent grid walks any number of
    rows, so the refusal here is the tensor map's (x's row at a stride of
    2^40 values, past what TMA takes; a one-row view, which the entry
    point's reshape would make contiguous, so the raw launcher is
    called)."""
    x = torch.zeros(8, dtype=torch.bfloat16, device=cuda).as_strided((1, 8), (2 ** 40, 1))
    w = torch.zeros((16, 8), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(16, dtype=torch.bfloat16, device=cuda)
    ln = (torch.ones(8, device=cuda), torch.zeros(8, device=cuda))
    port.launch_counts["swiglu"] = 0
    for lnp in (ln, None):
        with torch.inference_mode(), pytest.raises(RuntimeError, match="K2 swiglu launch failed"):
            port._swiglu_cuda(x, w, b, lnp, 1e-6)
    assert port.launch_counts["swiglu"] == 0
