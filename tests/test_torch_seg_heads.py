"""K3 (the fused marker heads) in the PyTorch port against the JAX package.

On the CPU the port runs K3's plain version, ``seg_heads_reference``, on the
weights ``fold_heads`` folds; both it and the eval-mode ``BatchedSegHeads``
are held against the JAX ``BatchedSegHeads(impl="pallas_interpret")``,
whose kernel ``_kernel`` runs in interpret mode. Training mode still runs the
batch-statistics chain, held against the JAX module's ``train=True``. The
``gpu`` tests hold the CUDA kernel against the plain version on the card;
they skip here. Run them on a machine with a card (tests/conftest.py imports
jax, which that machine lacks):

    python -m pytest tests/test_torch_seg_heads.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.models.mipheivit as port_model
from mipheivit_tpu_torch.models.mipheivit import BatchedSegHeads
from mipheivit_tpu_torch.ops import seg_heads as port

torch.set_num_threads(2)

# f32: the same function in another summation order, BN folded in f32 on both sides
ATOL, RTOL = 2e-5, 1e-4
# (batch, height, width, channels, heads): the JAX package's own parity case
# (tests/test_model_parity.py), the flagship widths (C = 32, 16 markers) and
# a 19-marker panel (more heads than one group of 16; H and W multiples of 8,
# as the JAX kernel needs)
CASES = {"parity": (2, 16, 32, 8, 3), "flagship": (2, 16, 24, 32, 16),
         "panel19": (1, 8, 16, 32, 19)}
# K3 against its plain version on the card, scaled to the reference: (max
# |err| / max |ref|, ||err|| / ||ref||); bf16 rounds g1 and the output
CARD_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-5)}


def _jax_heads(case, seed):
    """JAX BatchedSegHeads variables with non-trivial BN statistics and
    biases, an NHWC input, and the Pallas route's output (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models.mipheivit import BatchedSegHeads as JaxHeads

    b, h, w, c, k = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    variables = jax.tree.map(np.asarray, JaxHeads(k, impl="xla").init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    params = dict(variables["params"])
    for name in ("psi_conv1_bias", "psi_conv2_bias", "conv_bias"):
        params[name] = (rng.standard_normal(params[name].shape) * 0.3).astype(np.float32)
    nfeat = k * (c // 2)
    variables = {"params": params, "batch_stats": {"psi_bn": {
        "mean": (rng.standard_normal(nfeat) * 0.3).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, nfeat).astype(np.float32)}}}
    want = np.asarray(JaxHeads(k, impl="pallas_interpret").apply(
        variables, jnp.asarray(x), train=False))
    return variables, x, want


def _port_heads(variables, c, k):
    """The port's BatchedSegHeads with the JAX module's weights."""
    p, s = variables["params"], variables["batch_stats"]["psi_bn"]
    c2 = c // 2
    heads = BatchedSegHeads(c, k)
    state = {
        "psi_conv1.weight": p["psi_conv1_kernel"][:, 0, 0].transpose(0, 2, 1).reshape(k * c2, c),
        "psi_conv1.bias": p["psi_conv1_bias"].reshape(-1),
        "psi_bn.weight": p["psi_bn"]["scale"], "psi_bn.bias": p["psi_bn"]["bias"],
        "psi_bn.running_mean": s["mean"], "psi_bn.running_var": s["var"],
        "psi_conv2.weight": p["psi_conv2_kernel"][:, 0, 0, :, 0],
        "psi_conv2.bias": p["psi_conv2_bias"].reshape(-1),
        "conv_taps.weight": p["conv_kernel"][..., 0].transpose(1, 2, 0, 3).reshape(9 * k, c),
        "conv_bias": p["conv_bias"].reshape(-1),
    }
    state = {n: torch.from_numpy(np.array(v)) for n, v in state.items()}
    for n in ("psi_conv1.weight", "psi_conv2.weight", "conv_taps.weight"):
        state[n] = state[n][:, :, None, None]
    heads.load_state_dict(state, strict=False)
    return heads.eval()


def _nchw(x):
    """NHWC numpy -> the decoder's [B, C, H, W] channels_last tensor."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_and_eval_heads_match_jax_kernel(case):
    variables, x, want = _jax_heads(case, seed=len(case))
    _, _, _, c, k = CASES[case]
    heads = _port_heads(variables, c, k)
    xt = _nchw(x)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        ref = port.seg_heads_reference(xt, *port.fold_heads(heads, torch.float32))
        out = heads(xt)
    assert out.is_contiguous(memory_format=torch.channels_last)
    for got in (ref, out):
        assert got.shape == (x.shape[0], k) + x.shape[1:3]
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_runs_plain_version_without_launch():
    variables, x, _ = _jax_heads("parity", seed=1)
    heads = _port_heads(variables, 8, 3)
    port.launch_counts["seg_heads"] = 0
    with torch.inference_mode():
        out = heads(_nchw(x))
        ref = port.seg_heads_reference(_nchw(x), *port.fold_heads(heads, torch.float32))
    assert port.launch_counts["seg_heads"] == 0
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_fused_heads_take_channels_last_only():
    variables, x, _ = _jax_heads("parity", seed=2)
    weights = port.fold_heads(_port_heads(variables, 8, 3), torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        port.fused_seg_heads(_nchw(x).contiguous(), *weights)
    with pytest.raises(ValueError, match="CPU or all on one"):
        port.fused_seg_heads(torch.empty((1, 8, 4, 4), device="meta").to(
            memory_format=torch.channels_last), *weights)


def test_eval_heads_fold_once_while_the_weights_stay(monkeypatch):
    """Serving folds once: the folded weights are kept while every tensor of
    the module keeps its storage and version, folded again after an
    in-place change or a cast, and not kept where a gradient may flow."""
    variables, x, _ = _jax_heads("flagship", seed=4)
    heads = _port_heads(variables, 32, 16)
    folds = []

    def counting_fold(module, dtype):
        folds.append(dtype)
        return port.fold_heads(module, dtype)

    monkeypatch.setattr(port_model, "fold_heads", counting_fold)
    xt = _nchw(x)
    with torch.inference_mode():
        first = heads(xt)
        torch.testing.assert_close(heads(xt), first, rtol=0, atol=0)
    assert len(folds) == 1
    with torch.no_grad():
        heads.conv_bias.add_(0.5)
        heads.psi_bn.running_mean.mul_(2.0)
    with torch.inference_mode():
        moved = heads(xt)
        heads(xt)
    assert len(folds) == 2
    torch.testing.assert_close(
        moved, port.seg_heads_reference(xt, *port.fold_heads(heads, torch.float32)), rtol=0,
        atol=0)
    heads.psi_conv2.weight.data = heads.psi_conv2.weight.data.clone()
    with torch.inference_mode():
        heads(xt)
    assert len(folds) == 3
    out = heads(xt.requires_grad_())          # grad may flow: folded afresh
    heads(xt)
    assert len(folds) == 5
    out.sum().backward()
    assert heads.conv_bias.grad is not None


def test_fold_layout_needs_no_copy_at_16_heads():
    """At C = 32 and 16 heads, fold_heads' layout is the one K3 reads: the
    launcher's weights are views of the folded tensors."""
    variables, _, _ = _jax_heads("flagship", seed=5)
    weights = port.fold_heads(_port_heads(variables, 32, 16), torch.float32)
    kernel = port._padded_weights(*weights)
    assert all(t.is_contiguous() for t in kernel)
    assert [t.data_ptr() for t in kernel] == [t.data_ptr() for t in weights]
    assert kernel[0].shape == (16 * 16, 32) and kernel[4].shape == (9 * 16, 32)


def test_padded_weights_round_heads_up_to_groups_of_8():
    """At 19 heads the kernel's weights are padded to 24: the tap matrix's
    row t*24 + k is wm's column t*19 + k, and every padded head's weights
    and biases are zero (its m is 0, so nothing of it reaches the output)."""
    variables, _, _ = _jax_heads("panel19", seed=6)
    weights = port.fold_heads(_port_heads(variables, 32, 19), torch.float32)
    w1t, b1, w2, b2, wmt, bf = port._padded_weights(*weights)
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (w1t, b1, w2, b2, wmt, bf))
    assert w1t.shape == (24 * 16, 32) and b1.shape == (24 * 16,) and w2.shape == (24, 16)
    assert b2.shape == bf.shape == (24,) and wmt.shape == (9 * 24, 32)
    wm = weights[4]
    for t in range(9):
        torch.testing.assert_close(wmt[t * 24:t * 24 + 19], wm[:, t * 19:(t + 1) * 19].t(),
                                   rtol=0, atol=0)
        assert not wmt[t * 24 + 19:(t + 1) * 24].any()
    torch.testing.assert_close(w1t[:19 * 16], weights[0].t(), rtol=0, atol=0)
    for pad in (w1t[19 * 16:], b1[19 * 16:], w2[19:], b2[19:], bf[19:]):
        assert not pad.any()


def test_training_mode_runs_batch_statistics(monkeypatch):
    """train(): batch statistics normalise and the running statistics move,
    as the JAX module's train=True (its fused route is gated off there too);
    the fused route is never taken."""
    import jax.numpy as jnp

    from mipheivit_tpu.models.mipheivit import BatchedSegHeads as JaxHeads

    def no_fused(*args, **kwargs):
        raise AssertionError("the fused route ran in training mode")

    monkeypatch.setattr(port_model, "fused_seg_heads", no_fused)
    variables, x, _ = _jax_heads("flagship", seed=3)
    want, new_vars = JaxHeads(16, impl="pallas_interpret").apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    heads = _port_heads(variables, 32, 16).train()
    xt = _nchw(x).requires_grad_()
    out = heads(xt)
    out.sum().backward()
    assert xt.grad is not None
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(heads.psi_bn, name).numpy(),
                                   np.asarray(new_vars["batch_stats"]["psi_bn"][key]),
                                   atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_heads(k, device, dtype, seed, c=32):
    """A BatchedSegHeads at C = c (32 unless given) with random weights, BN
    statistics and biases, folded for the kernel."""
    torch.manual_seed(seed)
    heads = BatchedSegHeads(c, k)
    with torch.no_grad():
        for p in heads.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
        heads.psi_bn.running_mean.copy_(torch.randn(k * (c // 2)) * 0.3)
        heads.psi_bn.running_var.copy_(torch.rand(k * (c // 2)) + 0.5)
    return heads.to(device).eval(), port.fold_heads(heads.to(device), dtype)


def _scaled(got, want):
    err = got.float() - want.float()
    return ((err.abs().max() / want.float().abs().max()).item(),
            (err.norm() / want.float().norm()).item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,w,k,act", [
    (3, 128, 128, 16, "tanh"), (2, 37, 50, 16, "tanh"), (1, 20, 15, 5, "sigmoid"),
    (2, 9, 300, 16, None),
    # any number of heads. One pass: 1 and 5 (of 16 heads), 19 and 24 (of 24);
    # rows of 2K bytes not a multiple of 16 (K 1, 5, 19: a 19-marker pixel is
    # 38 B) leave by 16-byte vector stores of their span, whose edge chunks
    # two items beside each other share (W 200, 300). Two passes: 32 (16 + 16),
    # 37 and 40 (24 + 16; 37 stores each pass's heads pixel by pixel)
    (2, 37, 50, 1, "tanh"), (1, 20, 200, 5, "tanh"), (2, 37, 50, 19, "tanh"),
    (1, 9, 300, 19, None), (2, 33, 130, 24, "sigmoid"), (2, 33, 70, 32, "sigmoid"),
    (1, 20, 100, 37, "tanh"), (1, 20, 100, 40, "tanh"),
    # a 1024-px row: several 64-column items side by side
    (1, 12, 1024, 16, "tanh"), (1, 12, 1024, 19, "tanh")])
def test_kernel_matches_plain_on_card(cuda, b, h, w, k, act, dtype):
    _, weights = _card_heads(k, cuda, dtype, seed=h + w)
    x = torch.randn((b, h, w, 32), generator=torch.Generator().manual_seed(w)).to(
        cuda, dtype).permute(0, 3, 1, 2)
    port.launch_counts["seg_heads"] = 0
    with torch.inference_mode():
        got = port.fused_seg_heads(x, *weights, activation=act)
        want = port.seg_heads_reference(x, *weights, activation=act)
        torch.cuda.synchronize()
    assert port.launch_counts["seg_heads"] == 1
    assert got.shape == (b, k, h, w) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    rel, fro = _scaled(got, want)
    assert rel <= CARD_TOL[dtype][0] and fro <= CARD_TOL[dtype][1], (rel, fro)


@pytest.mark.gpu
def test_eval_heads_launch_k3_on_card(cuda):
    heads, _ = _card_heads(16, cuda, torch.bfloat16, seed=5)
    heads = heads.to(torch.bfloat16)
    x = torch.randn((2, 32, 64, 64), device=cuda, dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    port.launch_counts["seg_heads"] = 0
    with torch.inference_mode():
        out = heads(x)
        want = port.seg_heads_reference(x, *port.fold_heads(heads, torch.bfloat16))
        torch.cuda.synchronize()
    assert port.launch_counts["seg_heads"] == 1
    assert max(_scaled(out, want)) <= 2e-2


@pytest.mark.gpu
def test_eval_heads_launch_k3_once_at_19_heads(cuda):
    heads, _ = _card_heads(19, cuda, torch.bfloat16, seed=7)
    heads = heads.to(torch.bfloat16)
    x = torch.randn((2, 32, 64, 96), device=cuda, dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    port.launch_counts["seg_heads"] = 0
    with torch.inference_mode():
        out = heads(x)
        want = port.seg_heads_reference(x, *port.fold_heads(heads, torch.bfloat16))
        torch.cuda.synchronize()
    assert port.launch_counts["seg_heads"] == 1
    assert out.shape == (2, 19, 64, 96) and out.is_contiguous(memory_format=torch.channels_last)
    rel, fro = _scaled(out, want)
    assert rel <= CARD_TOL[torch.bfloat16][0] and fro <= CARD_TOL[torch.bfloat16][1], (rel, fro)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    heads, weights = _card_heads(16, cuda, torch.float32, seed=6)
    x = torch.randn((1, 32, 16, 16), device=cuda).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="no backward"):
        heads(x.requires_grad_())
    with pytest.raises(ValueError, match="one dtype"):
        port._seg_heads_cuda(x.detach().bfloat16(), *weights, "tanh")
    x8 = torch.randn((1, 8, 16, 16), device=cuda).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match=r"w1eff \[C, K\*C2\]"):   # x's C is not the weights'
        port._seg_heads_cuda(x8, *weights, "tanh")
    _, wide = _card_heads(16, cuda, torch.float32, seed=7, c=80)
    x80 = torch.randn((1, 80, 16, 16), device=cuda).to(memory_format=torch.channels_last)
    launches = port.launch_counts["seg_heads"]
    with torch.no_grad(), pytest.raises(ValueError, match="C <= 64"):  # above K3's widest
        port.fused_seg_heads(x80, *wide)
    assert port.launch_counts["seg_heads"] == launches
