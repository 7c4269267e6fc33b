"""The train step over gloo ranks on the CPU: data parallelism (each rank
its rows of the global batch, BatchNorm statistics over the global batch,
gradients averaged) and sequence sharding (the ViT's tokens over a model
group, the encoder's partial gradients summed), against one process at the
same global batch and against the JAX step on a 2-device data mesh.

The ranks are processes (``parallel.spawn``) running
``parallel.workers.train_steps``: a MipheiViT (width 128, 2 blocks, LoRA
rank 8, 64 px, 69 tokens), four microbatches of 4 with accumulation 2
(two optimizer steps, the first a zero update). Against one process at
the same global batch both sides run in f64 (in f32 a ReLU input within
rounding of 0 takes the other branch on one side and moves every gradient
upstream by ~2e-3 of its norm: ``tests/test_torch_train.py``), within 1e-5
relative for the data-parallel ranks and 1e-4 for the sequence-sharded
ones; against the JAX step on a 2-device data mesh in f32, within 1e-4 on
the loss and 1e-2 in norm on the gradients. A doubled or halved encoder
gradient is off by 100 %.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch
from mipheivit_tpu_torch.parallel import workers
from mipheivit_tpu_torch.parallel.spawn import spawn

from test_torch_seq_shard import _jax_model

torch.set_num_threads(2)

OUT = 2
RANK_RTOL = 1e-5
SHARD_RTOL = 1e-4
JAX_LOSS_RTOL, JAX_GRAD_NORM_RTOL = 1e-4, 1e-2
GRAD_NORM_FLOOR = 1e-6
VIT = dict(img_size=(64, 64), patch_size=8, embed_dim=128, depth=2, num_heads=2,
           mlp_hidden_dim=256, reg_tokens=4, no_embed_class=True, lora_rank=8)


def _batches(n=4, b=4, seed=6):
    g = np.random.default_rng(seed)
    return [{"image": g.standard_normal((b, 64, 64, 3)).astype(np.float32),
             "target": g.uniform(-0.9, 0.9, (b, 64, 64, OUT)).astype(np.float32)}
            for _ in range(n)]


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def runs():
    """The JAX model and weights, one process's run, and the runs over 2
    ranks (data parallel, with and without the GAN; sequence-sharded, with
    and without block checkpointing) and over 4 (2 x 2)."""
    model, variables, state = _jax_model(VIT, OUT, seed=4)
    torch.manual_seed(0)
    disc = DiscriminatorPatch(3 + OUT, ndf=8, n_layers=2)
    spec = dict(vit=VIT, out_chans=OUT, state=state, batches=_batches(),
                weights=np.random.default_rng(7).uniform(1.0, 2.0, OUT).astype(np.float32),
                lr=1e-3, total_iters=40, warmup=2, accum=2)
    f64 = dict(spec, dtype="float64")
    out = {"jax": (model, variables, spec), "solo": workers.train_steps(f64)}
    two = spawn(workers.tasks, 2, [
        (workers.train_steps, (spec,)),
        (workers.train_steps, (dict(spec, disc_state={k: v.numpy() for k, v in
                                                      disc.state_dict().items()}),)),
        (workers.train_steps, (f64,)),
        (workers.train_steps, (dict(f64, n_model=2),)),
        (workers.train_steps, (dict(f64, n_model=2, grad_checkpointing=True),))],
        device="cpu", timeout=300)
    out["dp32"], out["gan"], out["dp"], out["sp"], out["sp_ckpt"] = zip(*two)
    out["dp_sp"] = spawn(workers.train_steps, 4, (dict(f64, n_model=2),), device="cpu",
                         timeout=300)
    return out


def _same_replicas(per_rank):
    assert len({r["digest"] for r in per_rank}) == 1
    assert len({r["disc_digest"] for r in per_rank}) == 1


@pytest.mark.parametrize("case", ["dp32", "gan", "dp", "sp", "sp_ckpt", "dp_sp"])
def test_replicas_are_bit_identical_after_two_updates(runs, case):
    per_rank = runs[case]
    _same_replicas(per_rank)
    assert all(r["step"] == 4 for r in per_rank)
    # the trainable weights moved from where they started
    start = runs["jax"][2]["state"]
    moved = [k for k, v in per_rank[0]["state"].items()
             if ("lora_" in k or k.startswith("decoder.")) and k in start
             and not np.array_equal(v, start[k])]
    assert any("lora_" in k for k in moved) and any(k.startswith("decoder.") for k in moved)


@pytest.mark.parametrize("case", ["dp", "sp", "sp_ckpt", "dp_sp"])
def test_ranks_match_one_process_at_the_same_global_batch(runs, case):
    """Losses of every microbatch, the first one's reduced gradients and the
    weights after two updates (BatchNorm running statistics included)
    against one process taking the whole global batch. The data-parallel
    runs shard the batch; the sequence-sharded ones shard the tokens and
    their encoder gradients are sums over the model group."""
    solo, got = runs["solo"], runs[case][0]
    tol = RANK_RTOL if case == "dp" else SHARD_RTOL
    for a, b in zip(got["losses"], solo["losses"]):
        for key in ("gen_loss", "gen_loss_sim"):
            assert abs(a[key] - b[key]) <= tol * abs(b[key]), (key, a[key], b[key])
    assert set(got["grads0"]) == set(solo["grads0"])
    for name, grad in got["grads0"].items():
        want = solo["grads0"][name]
        err = np.linalg.norm(grad - want)
        assert err <= tol * np.linalg.norm(want) + GRAD_NORM_FLOOR * np.sqrt(grad.size), name
    for name, value in got["state"].items():
        np.testing.assert_allclose(value, solo["state"][name], rtol=tol, atol=1e-6,
                                   err_msg=name)


def test_batch_norm_trains_on_global_statistics(runs):
    """BatchNorm ran in training mode on every rank, and its running
    statistics equal one process's over the global batch."""
    solo = runs["solo"]["state"]
    for r in runs["dp"] + runs["dp32"]:
        assert r["bn_training"] == [True]
    for r in runs["dp"]:
        for name in (k for k in solo if "running_" in k):
            np.testing.assert_allclose(r["state"][name], solo[name], rtol=RANK_RTOL, atol=1e-7)


def test_data_parallel_step_matches_jax_on_a_2_device_mesh(runs):
    """The JAX step jitted over a batch sharded on a 2-device data mesh:
    its losses and the first microbatch's trainable gradients."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.metrics import PixelMetrics as JM
    from mipheivit_tpu.parallel import make_mesh, replicated, shard_batch
    from mipheivit_tpu.train import losses as jl
    from mipheivit_tpu.train import optim as jo
    from mipheivit_tpu.train import steps as js
    from mipheivit_tpu_torch.models.convert import state_dict_from_jax
    from mipheivit_tpu_torch.models.vit import ViTConfig

    model, variables, spec = runs["jax"]
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    gen_opt = jo.build_generator_optimizer("myvitmatte", spec["lr"], spec["total_iters"],
                                           warmup_iters=spec["warmup"],
                                           grad_accum_steps=spec["accum"])
    batches = [shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh)
               for b in spec["batches"]]
    state = js.create_train_state(jax.random.PRNGKey(0), model, gen_opt,
                                  sample_batch=batches[0], gen_variables=variables,
                                  freeze_model_name="myvitmatte")
    state = jax.device_put(state, replicated(mesh))
    loss_fn = jl.weighted_mse_loss(50.0, spec["weights"])
    step = jax.jit(js.make_train_step(model, loss_fn, gen_opt,
                                      cfg=js.StepConfig(freeze_model_name="myvitmatte")))
    trainable, frozen = jo.partition_params(state.gen_params, "myvitmatte")

    def gen_loss(tp, b):
        out, _ = model.apply({"params": jo.combine_params(tp, frozen),
                              "batch_stats": state.gen_batch_stats}, b["image"], train=True,
                             mutable=["batch_stats"])
        return loss_fn(b["target"], out)

    grads = jax.jit(jax.grad(gen_loss))(trainable, batches[0])
    want_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)},
                                     ViTConfig(**VIT), OUT)
    metrics = jax.device_put(JM.zeros(), replicated(mesh))
    got = runs["dp32"][0]
    for i, b in enumerate(batches):
        state, metrics, log = step(state, b, metrics)
        want = float(log["gen_loss"])
        assert abs(got["losses"][i]["gen_loss"] - want) <= JAX_LOSS_RTOL * abs(want), i
    assert set(got["grads0"]) == set(want_grads)
    for name, grad in got["grads0"].items():
        err = np.linalg.norm(grad - want_grads[name])
        bound = JAX_GRAD_NORM_RTOL * np.linalg.norm(want_grads[name]) + \
            GRAD_NORM_FLOOR * np.sqrt(grad.size)
        assert err <= bound, (name, err, bound)


def test_sequence_sharded_gradients_are_neither_doubled_nor_halved(runs):
    """The LoRA and decoder gradients of the sequence-sharded step, by
    group: each within 1e-4 of one process's (a summed-twice or an
    unsummed encoder gradient would be off by a factor of 2)."""
    solo = runs["solo"]["grads0"]
    for case in ("sp", "dp_sp"):
        got = runs[case][0]["grads0"]
        for part in ("lora_q", "lora_v", "decoder."):
            names = [n for n in got if part in n]
            assert names, part
            a = np.concatenate([got[n].ravel() for n in names])
            b = np.concatenate([solo[n].ravel() for n in names])
            assert _rel(a, b) <= SHARD_RTOL, (case, part, _rel(a, b))
