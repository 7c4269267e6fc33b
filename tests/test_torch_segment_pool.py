"""Per-nucleus pooling in the PyTorch port against the JAX package.

``nucleus_pool`` and ``segment_mean_pool`` against
``mipheivit_tpu.ops.segment_pool`` on the same labels and values from a
numpy seed: ids and counts exactly, sums and means within 1e-6 of the
largest, the mean pool's gradient against ``jax.grad`` within 1e-6. The
label maps cover a capacity overflow (labels past the K-th distinct one
are dropped), tiles without background, all background and ids near
2**31. The ``gpu`` test holds the card's pooling against the CPU's; it
skips here. Run it on a machine with a card (tests/conftest.py imports
jax, which that machine lacks):

    python -m pytest tests/test_torch_segment_pool.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.ops.segment_pool import nucleus_pool, segment_mean_pool

torch.set_num_threads(2)

RTOL = 1e-6        # of the largest sum or mean
GRAD_TOL = 1e-6
B, H, W, C = 3, 24, 20, 4


def _labels(case: str, rng) -> np.ndarray:
    if case == "background":
        labels = rng.integers(1, 30, (B, H, W)) * rng.integers(0, 2, (B, H, W))
    elif case == "overflow":                  # ~40 distinct labels a tile, capacity 8
        labels = rng.integers(0, 40, (B, H, W))
    elif case == "no_background":
        labels = rng.integers(1, 12, (B, H, W))
    elif case == "all_background":
        labels = np.zeros((B, H, W))
    elif case == "near_2_31":
        labels = rng.integers(2 ** 31 - 25, 2 ** 31, (B, H, W)) * rng.integers(0, 2, (B, H, W))
    elif case == "discs":                     # nuclei as discs, one tile shares no label
        labels = np.zeros((B, H, W))
        yy, xx = np.mgrid[:H, :W]
        for b in range(B):
            for j in range(6):
                cy, cx, r = rng.integers(0, H), rng.integers(0, W), rng.integers(2, 5)
                labels[b][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1000 * b + j + 1
    return labels.astype(np.int32)


CASES = ["background", "overflow", "no_background", "all_background", "near_2_31", "discs"]
CAPACITY = {"overflow": 8}


def _close(got, want, rtol=RTOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("case", CASES)
def test_nucleus_pool_matches_jax(case):
    import jax.numpy as jnp

    from mipheivit_tpu.ops.segment_pool import nucleus_pool as jax_pool

    rng = np.random.default_rng(CASES.index(case))
    labels = _labels(case, rng)
    values = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k = CAPACITY.get(case, 64)
    want = [np.asarray(a) for a in jax_pool(jnp.asarray(values), jnp.asarray(labels), k)]
    got = [t.numpy() for t in nucleus_pool(torch.from_numpy(values), torch.from_numpy(labels), k)]
    assert got[0].dtype == np.int32 and got[1].dtype == got[2].dtype == np.float32
    assert [g.shape for g in got] == [(B, k), (B, k, C), (B, k)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    _close(got[1], want[1])
    if case == "overflow":
        assert (got[2].sum(1) < H * W).all()          # the labels past K are dropped
    if case == "all_background":
        assert (got[2][:, 0] == H * W).all() and not got[2][:, 1:].any()


def test_nucleus_pool_sums_bf16_in_f32():
    """bf16 values are pooled in f32, as the JAX ``CellMetrics.pool`` pools
    the f32 copy of its predictions."""
    import jax.numpy as jnp

    from mipheivit_tpu.ops.segment_pool import nucleus_pool as jax_pool

    rng = np.random.default_rng(7)
    labels = _labels("discs", rng)
    values = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).bfloat16()
    ids, sums, counts = nucleus_pool(values, torch.from_numpy(labels), 32)
    want = jax_pool(jnp.asarray(values.float().numpy()), jnp.asarray(labels), 32)
    assert sums.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    _close(sums.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("case", ["background", "overflow", "near_2_31"])
def test_segment_mean_pool_and_its_gradient_match_jax(case):
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.ops.segment_pool import segment_mean_pool as jax_mean

    rng = np.random.default_rng(10 + CASES.index(case))
    labels = _labels(case, rng)
    values = rng.standard_normal((B, H, W, C)).astype(np.float32)
    weights = rng.standard_normal((C,)).astype(np.float32)
    k = CAPACITY.get(case, 64)

    def jax_loss(v):
        _, means, valid = jax_mean(v, jnp.asarray(labels), k)
        return jnp.sum((means ** 2 * weights).sum(-1) * valid)

    want_ids, want_means, want_valid = (np.asarray(a) for a in jax_mean(
        jnp.asarray(values), jnp.asarray(labels), k))
    want_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(values)))

    v = torch.from_numpy(values).requires_grad_()
    ids, means, valid = segment_mean_pool(v, torch.from_numpy(labels), k)
    loss = torch.sum((means ** 2 * torch.from_numpy(weights)).sum(-1) * valid)
    (grad,) = torch.autograd.grad(loss, v)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    _close(means.detach().numpy(), want_means)
    _close(grad.numpy(), want_grad, GRAD_TOL)
    assert valid.sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_nucleus_pool_on_card_matches_cpu(case):
    """The card's pooling (no host sync: it runs under
    ``set_sync_debug_mode("error")``) against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(CASES.index(case))
    labels = torch.from_numpy(_labels(case, rng))
    values = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    k = CAPACITY.get(case, 64)
    want = nucleus_pool(values, labels, k)
    labels_d, values_d = labels.cuda(), values.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = nucleus_pool(values_d, labels_d, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [t.cpu().numpy() for t in got]
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())
    _close(got[1], want[1].numpy(), 1e-5)
