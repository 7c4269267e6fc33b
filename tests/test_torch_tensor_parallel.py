"""Tensor parallelism (``parallel/sharding.py``) over gloo ranks on the CPU,
against the JAX package's ``parallel.sharding`` on the 8-device CPU mesh of
``tests/conftest.py``.

The port's ranks are processes (``parallel.spawn``) that run the plain
versions of K1, K2 and K4; one spawn of 4 ranks (``dp 2 x tp 2``) runs
every case of this file (``parallel.workers.tasks``). The JAX side shards
over its ``dp 4 x tp 2`` mesh, the port over ``dp 2 x tp 2``: the rows of
a global batch split over the data ranks, the heads and the MLP's hidden
width over the model ranks.

- Specs: the class of every parameter, name for name, against the JAX rule.
- Forward: ``tests/test_tensor_parallel.py``'s generator (LoRA live), the
  same at 96 px (581 tokens: the K4 route's plain version) and a ViT UNETR,
  within ``MODEL_ATOL`` / 1e-3 of JAX's sharded forward and 1e-5 of the
  port's unsharded one.
- Training, f64, two optimizer steps of global batches of 4 (the first a
  zero update) of ``myvitmatte`` (frozen encoder, LoRA; the adapters'
  gradients are partial sums over the model group; accumulation 2) and
  ``unet_lora`` (the whole encoder trains: shards with their own gradients
  and the clip norm over the model group): losses, the first microbatch's
  gradients and the weights after the steps within 1e-5 of one process's
  at the same global batch, the first loss within 1e-4 of JAX's on the
  sharded mesh; a doubled or halved gradient is off by 100 %.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models.convert import state_dict_from_jax, unetr_state_dict_from_jax
from mipheivit_tpu_torch.models.vit import ViTConfig
from mipheivit_tpu_torch.parallel import encoder_param_specs, workers
from mipheivit_tpu_torch.parallel.mesh import Mesh
from mipheivit_tpu_torch.parallel.spawn import spawn

from test_torch_seq_shard import _fill

torch.set_num_threads(2)

MODEL_ATOL = 5e-4            # the JAX forward (f32, another order of sums)
UNSHARDED_TOL = 1e-5         # the port's own unsharded forward
RANK_RTOL = 1e-5             # one process's f64 training run
JAX_LOSS_RTOL = 1e-4
GRAD_NORM_FLOOR = 1e-6
N_DATA, N_MODEL = 2, 2
# tests/test_tensor_parallel.py's generator; 69 tokens
GEN = dict(img_size=(32, 32), patch_size=4, embed_dim=32, depth=2, num_heads=2,
           mlp_hidden_dim=64, reg_tokens=4, lora_rank=2)
GEN96 = dict(GEN, img_size=(96, 96))                    # 24 x 24 + 5 = 581 tokens
UNETR = dict(img_size=(32, 32), patch_size=16, embed_dim=64, depth=4, num_heads=2,
             mlp_hidden_dim=128, reg_tokens=4, lora_rank=2)
OUT = 4
FORWARDS = {"gen": (GEN, 8, False), "gen96": (GEN96, 4, False), "unetr": (UNETR, 4, True)}
# (config, UNETR, accumulation): two optimizer steps each; the UNETR's decoder
# syncs a BatchNorm over the data ranks at every layer, so it takes one
# microbatch a step
TRAIN = {"myvitmatte": (GEN, False, 2), "unet_lora": (UNETR, True, 1)}


def _jax_module(kw, unetr):
    from mipheivit_tpu.models import MipheiViT, ViTConfig as JaxCfg
    from mipheivit_tpu.models.unetr import UnetrViT

    cfg = JaxCfg(attn_impl="xla", remat=False, **kw)
    return UnetrViT(vit_cfg=cfg, out_chans=OUT) if unetr else MipheiViT(vit_cfg=cfg, out_chans=OUT)


def _jax_variables(module, kw, seed):
    """Seeded numpy variables (shapes from ``jax.eval_shape``; LoRA B
    non-zero) and the port's state dict of them."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda k: module.init(k, jnp.zeros((1,) + kw["img_size"] + (3,)),
                                                  train=False), jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)
    variables = jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(
        lambda p, t: _fill(p, t.shape, g), shapes))
    cfg = ViTConfig(**kw)
    if "encoder_vit" in variables["params"]:
        return variables, unetr_state_dict_from_jax(variables, cfg)
    return variables, state_dict_from_jax(variables, cfg, OUT)


def _sharded_jit(fn, mesh, variables, *args):
    """``fn(variables, *args)`` jitted with the params placed by the JAX
    ``shard_params``, the rest replicated, the arrays' rows on the data axis."""
    import jax

    from mipheivit_tpu.parallel import batch_sharding, replicated, shard_params

    placed = dict(jax.device_put(variables, replicated(mesh)),
                  params=shard_params(variables["params"], mesh))
    args = [jax.tree.map(lambda a: jax.device_put(a, batch_sharding(mesh)), a) for a in args]
    return jax.jit(fn)(placed, *args)


def _batches(img, n=4, b=4, seed=6):
    g = np.random.default_rng(seed)
    return [{"image": g.standard_normal((b, img, img, 3)).astype(np.float32),
             "target": g.uniform(-0.9, 0.9, (b, img, img, OUT)).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def cases():
    """JAX's sharded forwards and first training losses, one process's
    training runs, and every rank's results of one spawn of 4 (which runs
    while JAX compiles)."""
    import jax

    from mipheivit_tpu.parallel import make_mesh
    from mipheivit_tpu.train import losses as jl

    g = np.random.default_rng(3)
    out = {"jax": {}, "state": {}, "x": {}, "solo": {}, "spec": {}}
    calls, jax_work = [], []
    for seed, (name, (kw, b, unetr)) in enumerate(FORWARDS.items()):
        module = _jax_module(kw, unetr)
        variables, state = _jax_variables(module, kw, seed)
        x = g.standard_normal((b,) + kw["img_size"] + (3,)).astype(np.float32)
        jax_work.append((name, lambda v, xx, module=module: module.apply(v, xx, train=False),
                         variables, x))
        out["state"][name], out["x"][name] = state, x
        calls.append((("forward", name), (workers.tp_forward,
                                          (kw, OUT, state, x, N_MODEL, unetr))))
    weights = np.random.default_rng(7).uniform(1.0, 2.0, OUT).astype(np.float32)
    loss_fn = jl.weighted_mse_loss(50.0, weights)
    for seed, (family, (kw, unetr, accum)) in enumerate(TRAIN.items(), start=10):
        module = _jax_module(kw, unetr)
        variables, state = _jax_variables(module, kw, seed)
        batches = _batches(kw["img_size"][0], n=2 * accum, seed=seed)

        def loss(v, b, module=module):
            fake, _ = module.apply(v, b["image"], train=True, mutable=["batch_stats"])
            return loss_fn(b["target"], fake)

        jax_work.append((family, loss, variables, batches[0]))
        spec = dict(vit=kw, out_chans=OUT, state=state, batches=batches, weights=weights,
                    lr=1e-3, total_iters=40, warmup=2, accum=accum, family=family,
                    dtype="float64")
        out["solo"][family] = solo = workers.train_steps(spec)
        out["spec"][family] = spec
        calls.append((("train", family), (workers.train_steps, (dict(
            spec, n_model=N_MODEL, tp=True, return_state="rank0",
            opt_ref={k: v for k, v in solo["opt"].items() if _sharded(k)}),))))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, workers.tasks, N_DATA * N_MODEL, [c for _, c in calls],
                            device="cpu", timeout=300)
        mesh = make_mesh(n_data=8 // N_MODEL, n_model=N_MODEL, devices=jax.devices()[:8])
        for name, fn, variables, arg in jax_work:
            out["jax"][name] = np.asarray(_sharded_jit(fn, mesh, variables, arg))
        results = ranks.result()
    out["port"] = {tag: per_rank for (tag, _), *per_rank in zip(calls, *results)}
    return out


def _sharded(name):
    from mipheivit_tpu_torch.parallel.sharding import COLUMN, ROW

    return ".blocks." in name and name.split(".blocks.", 1)[1].split(".", 1)[1] in COLUMN + ROW


def _spec_codes(tree):
    """JAX ``encoder_param_specs`` as arrays of each leaf's shape: 1
    replicated, 2 ``"model"`` on the output (last) axis, 3 on the input axis."""
    import jax

    from mipheivit_tpu.parallel import encoder_param_specs as jax_specs

    def code(leaf, spec):
        axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        c = 1 if not axes else (2 if axes == [leaf.ndim - 1] else 3)
        assert not axes or axes in ([leaf.ndim - 1], [leaf.ndim - 2]), spec
        return np.full(leaf.shape, c, np.float32)

    return jax.tree.map(code, tree, jax_specs(tree))


@pytest.mark.parametrize("name", ["gen", "unetr"])
def test_encoder_param_specs_match_jax(name):
    """The class of every parameter of the flagship generator (LoRA 2) and of
    a ViT UNETR, name for name: the JAX specs, written through the port's
    converters as arrays of codes, column <=> ``"model"`` on the output
    axis, row <=> on the input axis; everything outside the encoder
    replicated on both sides."""
    import jax

    from mipheivit_tpu_torch.models.mipheivit import MipheiViT
    from mipheivit_tpu_torch.models.unetr import UnetrViT
    from mipheivit_tpu_torch.train.optim import jax_path

    kw, _, unetr = FORWARDS[name]
    variables, _ = _jax_variables(_jax_module(kw, unetr), kw, 0)
    codes = _spec_codes(variables["params"])
    cfg = ViTConfig(**kw)
    scope = "encoder_vit" if unetr else "encoder"
    outside = {k: v for k, v in codes.items() if k != scope}
    assert all(np.all(leaf == 1) for leaf in jax.tree.leaves(outside))
    if unetr:
        port = UnetrViT(cfg, OUT)
        mapped = unetr_state_dict_from_jax({"params": {"encoder_vit": codes[scope]}}, cfg)
    else:
        port = MipheiViT(cfg, OUT)
        mapped = state_dict_from_jax({"params": {"encoder": codes[scope]}}, cfg, OUT)
    specs = encoder_param_specs(port)
    classes = {1: None, 2: "column", 3: "row"}
    for key, arr in mapped.items():
        assert arr.min() == arr.max(), key
        assert specs[key] == classes[int(arr.flat[0])], (key, specs[key])
    encoder = {k for k in specs if jax_path(port, k).startswith(
        "encoder_vit." if unetr else "encoder.vit.")}
    assert encoder == set(mapped)
    assert all(specs[k] is None for k in set(specs) - encoder)
    assert {v for v in specs.values()} == {None, "column", "row"}
    lora = [k for k in specs if ".lora_" in k]
    assert lora and all(specs[k] is None for k in lora)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sharded_forward_matches_jax(cases, name):
    """Each rank's rows of the tensor-parallel eval forward against the JAX
    forward on its dp 4 x tp 2 mesh; the two model ranks of a data row
    agree bit for bit."""
    per_rank = cases["port"]["forward", name]
    want = cases["jax"][name]
    rows = want.shape[0] // N_DATA
    for r, got in enumerate(per_rank):
        d = r // N_MODEL
        np.testing.assert_allclose(got, want[d * rows:(d + 1) * rows], atol=MODEL_ATOL,
                                   rtol=1e-3, err_msg=f"rank {r}")
    for d in range(N_DATA):
        np.testing.assert_array_equal(per_rank[d * N_MODEL], per_rank[d * N_MODEL + 1])


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sharded_forward_matches_unsharded(cases, name):
    """The same rows against the port's own unsharded forward of the same
    weights (the plain versions of K1 or K4 and K2 at every head and the
    whole hidden width)."""
    kw, _, unetr = FORWARDS[name]
    model = workers.build_generator(kw, OUT, cases["state"][name], device="cpu",
                                    unetr=unetr).eval()
    with torch.no_grad():
        want = model(torch.from_numpy(cases["x"][name])).numpy()
    rows = want.shape[0] // N_DATA
    for r, got in enumerate(cases["port"]["forward", name]):
        d = r // N_MODEL
        np.testing.assert_allclose(got, want[d * rows:(d + 1) * rows], atol=UNSHARDED_TOL,
                                   rtol=UNSHARDED_TOL, err_msg=f"rank {r}")


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("family", list(TRAIN))
def test_training_matches_one_process(cases, family):
    """Losses of every microbatch, the first microbatch's reduced gradients
    (the shards gathered whole) and every weight after two optimizer steps
    (BatchNorm statistics included) against one process at the same
    global batch."""
    solo, per_rank = cases["solo"][family], cases["port"]["train", family]
    for got in per_rank:
        assert got["step"] == 2 * TRAIN[family][2]
        for a, b in zip(got["losses"], solo["losses"]):
            for key in ("gen_loss", "gen_loss_sim"):
                assert abs(a[key] - b[key]) <= RANK_RTOL * abs(b[key]), (key, a[key], b[key])
    got = per_rank[0]
    assert set(got["grads0"]) == set(solo["grads0"])
    for name, grad in got["grads0"].items():
        want = solo["grads0"][name]
        assert np.linalg.norm(grad - want) <= (RANK_RTOL * np.linalg.norm(want)
                                               + GRAD_NORM_FLOOR * np.sqrt(grad.size)), name
    start = cases["spec"][family]["state"]
    moved = [k for k, v in got["state"].items() if k in start and not np.array_equal(v, start[k])]
    assert any(".lora_" in k for k in moved)
    # rank 0's, gathered whole; the others hold the same replicated tensors
    # and shards (test_replicated_tensors_identical_and_shards_split)
    assert set(got["state"]) == set(solo["state"])
    for name, value in got["state"].items():
        np.testing.assert_allclose(value, solo["state"][name], rtol=RANK_RTOL, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("family", list(TRAIN))
def test_first_loss_matches_jax_sharded_step(cases, family):
    """The first microbatch's loss (training-mode BatchNorm) against the JAX
    loss of the same global batch on its dp 4 x tp 2 mesh (JAX in f32)."""
    got = cases["port"]["train", family][0]["losses"][0]["gen_loss"]
    want = cases["jax"][family]
    assert abs(got - want) <= JAX_LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("family", list(TRAIN))
def test_replicated_tensors_identical_and_shards_split(cases, family):
    """After the steps the replicated tensors (the LoRA adapters among them)
    are bit-identical on every rank; each model rank's shards are
    identical across the data replicas and differ from the other model
    rank's."""
    per_rank = cases["port"]["train", family]
    assert len({r["digest"] for r in per_rank}) == 1
    for m in range(N_MODEL):
        assert len({r["shard_digest"] for r in per_rank[m::N_MODEL]}) == 1
    assert len({r["shard_digest"] for r in per_rank[:N_MODEL]}) == N_MODEL


def test_shard_opt_state_equals_the_sharded_run(cases):
    """``unet_lora`` trains its sharded tensors: one process's Adam moments
    sliced by ``shard_opt_state`` equal those that each rank's sharded run
    built, shard for shard."""
    for r, got in enumerate(cases["port"]["train", "unet_lora"]):
        assert len(got["opt"]) == 6 * UNETR["depth"] and all(map(_sharded, got["opt"]))
        assert set(got["opt_sliced"]) == set(got["opt"])
        for name, (mu, nu) in got["opt"].items():
            mu_s, nu_s = got["opt_sliced"][name]
            assert mu.shape == mu_s.shape, name
            for a, b in ((mu, mu_s), (nu, nu_s)):
                assert np.linalg.norm(a - b) <= RANK_RTOL * np.linalg.norm(b) + 1e-12, (r, name)


def _model(**kw):
    from mipheivit_tpu_torch.models.mipheivit import MipheiViT

    return MipheiViT(ViTConfig(**dict(GEN, **kw)), OUT)


def _int8():
    from mipheivit_tpu_torch.infer import merge_lora, quantize_encoder

    return quantize_encoder(merge_lora(_model()))


REJECTS = {
    "heads": (lambda: _model(num_heads=1, embed_dim=32), ValueError, "heads"),
    "hidden": (lambda: _model(mlp_hidden_dim=63), ValueError, "hidden"),
    "int8": (_int8, ValueError, "Int8Linear"),
    "seq_shard": (lambda: _model(attn_impl="seq_shard"), ValueError, "seq_shard"),
    "no_process_group": (_model, RuntimeError, "process group"),
}


@pytest.mark.parametrize("case", list(REJECTS))
def test_shard_params_rejects_before_any_collective(case):
    """Each unsupported model, and a two-rank model group without a process
    group, raises before any weight is cut or any collective starts."""
    from mipheivit_tpu_torch.parallel import shard_params

    make, error, match = REJECTS[case]
    model = make()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mesh = Mesh(n_data=1, n_model=N_MODEL, data_rank=0, model_rank=0, data_group=None,
                model_group=None)
    with pytest.raises(error, match=match):
        shard_params(model, mesh)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
