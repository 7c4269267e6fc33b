"""The cell loss in the PyTorch port against the JAX package.

``build_cell_loss`` of both packages on one seeded ``mlp.ckpt`` (the
reference's key layout ``model.{0,1,3,5}.*``) and the same predictions,
targets and nuclei from numpy seeds, for the MSE term only, the clustering
term only, both and neither: the value within 1e-5 relative and the
gradient with respect to the prediction within 1e-4 of its norm. The train
step adds the term to the generator loss and logs it as ``loss_cell``.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.train.cell_loss import ClusterMLP, build_cell_loss, load_cluster_mlp

torch.set_num_threads(2)

VALUE_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
B, HW, C = 2, 32, 3
CAPACITY = 64


def write_mlp(path, n_channels=C, seed=0, wrapped=False, with_norm=True):
    """A seeded cluster-MLP checkpoint in the reference's layout."""
    g = torch.Generator().manual_seed(seed)
    state = {"model.1.weight": torch.randn(16, n_channels, generator=g) * 0.05,
             "model.1.bias": torch.randn(16, generator=g) * 0.1,
             "model.3.weight": torch.randn(8, 16, generator=g) * 0.3,
             "model.3.bias": torch.randn(8, generator=g) * 0.1,
             "model.5.weight": torch.randn(n_channels, 8, generator=g) * 0.5,
             "model.5.bias": torch.randn(n_channels, generator=g) * 0.1}
    if with_norm:
        state["model.0.mean"] = torch.full((n_channels,), 120.0) + torch.randn(n_channels,
                                                                              generator=g)
        state["model.0.std"] = torch.full((n_channels,), 40.0) + torch.rand(n_channels,
                                                                           generator=g)
    torch.save({"state_dict": state} if wrapped else state, path)
    return str(path)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.9, 0.9, (B, HW, HW, C)).astype(np.float32)
    target = rng.uniform(-0.9, 0.9, (B, HW, HW, C)).astype(np.float32)
    nuclei = np.zeros((B, HW, HW), np.int32)
    yy, xx = np.mgrid[:HW, :HW]
    for b in range(B):
        for j in range(10):
            cy, cx, r = rng.integers(0, HW), rng.integers(0, HW), rng.integers(2, 6)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            nuclei[b][disc] = int(rng.integers(1, 2 ** 31 - 1))
            # bright cells in some channels, so that the MLP's labels differ
            pred[b][disc] = np.clip(pred[b][disc] + rng.uniform(-0.6, 0.6, C), -0.9, 0.9)
            target[b][disc] = np.clip(target[b][disc] + rng.uniform(-0.6, 0.6, C), -0.9, 0.9)
    return pred, target, nuclei


@pytest.mark.parametrize("use_mse,use_clustering", [(True, False), (False, True), (True, True),
                                                    (False, False)],
                         ids=["mse", "clustering", "both", "neither"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cell_loss_and_its_gradient_match_jax(tmp_path, use_mse, use_clustering, seed):
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.train.cell_loss import build_cell_loss as jax_build

    mlp = write_mlp(tmp_path / "mlp.ckpt", seed=seed)
    pred, target, nuclei = _inputs(seed)
    jax_loss = jax_build(mlp, C, use_mse=use_mse, use_clustering=use_clustering,
                         lambda_factor=50.0, capacity=CAPACITY)
    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred), jnp.asarray(target),
                                                   jnp.asarray(nuclei))
    want, want_grad = float(want), np.asarray(want_grad)

    loss = build_cell_loss(mlp, C, use_mse=use_mse, use_clustering=use_clustering,
                           lambda_factor=50.0, capacity=CAPACITY, device="cpu")
    p = torch.from_numpy(pred).requires_grad_()
    got = loss(p, torch.from_numpy(target), torch.from_numpy(nuclei))
    assert got.dtype == torch.float32 and got.shape == ()
    if not (use_mse or use_clustering):
        assert float(got) == want == 0.0 and not want_grad.any()
        return
    (grad,) = torch.autograd.grad(got, p)
    np.testing.assert_allclose(float(got), want, rtol=VALUE_RTOL)
    norm = np.linalg.norm(want_grad)
    assert norm > 0
    assert np.linalg.norm(grad.numpy() - want_grad) <= GRAD_NORM_RTOL * norm


@pytest.mark.parametrize("wrapped,with_norm", [(False, True), (True, False)])
def test_load_cluster_mlp_matches_jax(tmp_path, wrapped, with_norm):
    """Both layouts of ``mlp.ckpt`` (a bare state dict, or one under
    ``state_dict``; with or without the normalisation statistics), the
    MLP's output on the same cells."""
    import jax.numpy as jnp

    from mipheivit_tpu.train.cell_loss import _mlp_apply, load_cluster_mlp as jax_load

    path = write_mlp(tmp_path / "mlp.ckpt", seed=3, wrapped=wrapped, with_norm=with_norm)
    mlp = load_cluster_mlp(path, C)
    assert isinstance(mlp, ClusterMLP) and not any(p.requires_grad for p in mlp.parameters())
    assert set(mlp.state_dict()) == {f"model.{k}" for k in (
        "0.mean", "0.std", "1.weight", "1.bias", "3.weight", "3.bias", "5.weight", "5.bias")}
    x = np.random.default_rng(4).uniform(0, 255, (50, C)).astype(np.float32)
    want = np.asarray(_mlp_apply({k: jnp.asarray(v) for k, v in jax_load(path, C).items()},
                                 jnp.asarray(x)))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_clustering_needs_the_mlp():
    with pytest.raises(ValueError, match="mlp_path"):
        build_cell_loss(None, C, use_clustering=True)


def test_train_step_adds_the_cell_loss(tmp_path):
    """``make_train_step`` with the cell loss: ``gen_loss`` is the
    reconstruction term plus ``loss_cell``, and ``loss_cell`` is the loss
    of the step's prediction."""
    import torch_synthetic_run as syn
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.train import losses, optim, steps

    torch.manual_seed(0)
    model = syn.tiny_generator("myvitmatte", 32, C)
    opt = optim.build_generator_optimizer(1e-3, 10, 1)
    state = steps.create_train_state(model, opt, freeze_model_name="myvitmatte", device="cpu")
    cell = build_cell_loss(write_mlp(tmp_path / "mlp.ckpt"), C, capacity=CAPACITY)
    step = steps.make_train_step(model, losses.mse_loss(1.0), opt,
                                 cfg=steps.StepConfig(use_cell_loss=True), cell_loss_fn=cell)
    pred, target, nuclei = _inputs(5)
    image = np.random.default_rng(5).standard_normal((B, HW, HW, 3)).astype(np.float32)
    with torch.no_grad():
        model.train()
        want = cell(model(torch.from_numpy(image)), torch.from_numpy(target),
                    torch.from_numpy(nuclei))
    _, _, log = step(state, {"image": image, "target": target, "nuclei": nuclei},
                     PixelMetrics.zeros("cpu"))
    assert float(log["loss_cell"]) > 0
    np.testing.assert_allclose(float(log["loss_cell"]), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(log["gen_loss"]),
                               float(log["gen_loss_sim"]) + float(log["loss_cell"]), rtol=1e-6)
