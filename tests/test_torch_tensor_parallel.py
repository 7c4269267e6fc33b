"""Tensor parallelism (``parallel/sharding.py``) over gloo ranks on the CPU,
against the JAX package's ``parallel.sharding`` on the 8-device CPU mesh of
``tests/conftest.py``.

The port's ranks are processes (``parallel.spawn``) that run the plain
versions of K1, K2 and K4; one spawn of 4 ranks (``dp 2 x tp 2``) runs
every case of this file (``parallel.workers.tasks``). The JAX side shards
over its ``dp 4 x tp 2`` mesh, the port over ``dp 2 x tp 2``: the rows of
a global batch split over the data ranks, the heads and the MLP's hidden
width over the model ranks.

- Specs: the class of every parameter (and int8 buffer), name for name,
  against the JAX rule; the Swin MLP whole, the int8 scales with their
  weights.
- Forward: ``tests/test_tensor_parallel.py``'s generator (LoRA live), the
  same at 96 px (581 tokens: the K4 route's plain version), a ViT UNETR,
  the generator in int8 W8A8 (``merge_lora`` -> ``quantize_encoder``), a
  Swin UNETR with ctranspath's head counts (3 heads split 2 + 1) and a
  HEMIT dual-branch generator (1 head at stage 0: rank 1 holds none),
  within ``MODEL_ATOL`` / 1e-3 of JAX's sharded forward (int8: the
  per-marker Pearson and max error of ``tests/test_torch_quant.py``) and
  1e-5 of the port's unsharded one.
- The int8 row-split product's int32 accumulator equals the unsharded one
  bit for bit.
- Uneven layouts (3 heads over 2 and 4 ranks) round-trip through
  ``shard_slice`` / ``unshard`` / ``shard_opt_state``.
- Training, f64, two optimizer steps of global batches of 4 (the first a
  zero update) of ``myvitmatte`` (frozen encoder, LoRA; the adapters'
  gradients are partial sums over the model group; accumulation 2; also
  at 96 px, the region step's K4 / K5 route),
  ``unet_lora`` (the whole encoder trains: shards with their own gradients
  and the clip norm over the model group) and ``unet_lora`` on the Swin
  (the relative-position tables' gradients partial sums too, the Swin MLP
  whole): losses, the first microbatch's gradients and the weights after
  the steps within 1e-5 of one process's at the same global batch, the
  first loss within 1e-4 of JAX's on the sharded mesh; a doubled or halved
  gradient is off by 100 %.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models.convert import (hemit_state_dict_from_jax, state_dict_from_jax,
                                                unetr_state_dict_from_jax,
                                                unetr_swin_state_dict_from_jax)
from mipheivit_tpu_torch.models.swin import SwinConfig
from mipheivit_tpu_torch.models.vit import ViTConfig
from mipheivit_tpu_torch.parallel import encoder_param_specs, workers
from mipheivit_tpu_torch.parallel.mesh import Mesh
from mipheivit_tpu_torch.parallel.spawn import spawn

from test_torch_seq_shard import _fill

torch.set_num_threads(2)

MODEL_ATOL = 5e-4            # the JAX forward (f32, another order of sums)
UNSHARDED_TOL = 1e-5         # the port's own unsharded forward
# the int8 generator against JAX's int8 forward (tests/test_torch_quant.py)
INT8_PEARSON, INT8_ERR = 0.9999, 1e-2
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
# ctranspath's heads (3 at stage 0: 2 + 1 over 2 ranks), conv stem, LoRA 2,
# window 3 at 96 px (grids 24, 12, 6, 3: stage 2 shifts, stage 3 does not)
SWIN = dict(img_size=(96, 96), patch_size=4, embed_dim=24, depths=(2, 2, 2, 2),
            num_heads=(3, 6, 12, 24), window_size=3, conv_stem=True, lora_rank=2)
# a dual-branch HEMIT generator; its Swin runs stages 0-2, stage 0 at 1 head
HEMIT = dict(swin=dict(img_size=(64, 64), patch_size=4, embed_dim=16, depths=(1, 1, 2, 1),
                       num_heads=(1, 2, 4, 8), window_size=4), ngf=8, n_blocks=1, top_k=100)
OUT = 4
# (config, batch, family, int8)
FORWARDS = {"gen": (GEN, 8, "mipheivit", False), "gen96": (GEN96, 4, "mipheivit", False),
            "unetr": (UNETR, 4, "unetr", False), "int8": (GEN, 8, "mipheivit", True),
            "swin_unetr": (SWIN, 4, "unetr_swin", False), "hemit": (HEMIT, 4, "hemit", False)}
# (config, freeze family, architecture, accumulation): two optimizer steps
# each; a UNETR's decoder syncs a BatchNorm over the data ranks at every
# layer, so it takes one microbatch a step
TRAIN = {"myvitmatte": (GEN, "myvitmatte", "mipheivit", 2),
         "myvitmatte_region": (GEN96, "myvitmatte", "mipheivit", 1),   # K4 / K5's route
         "unet_lora": (UNETR, "unet_lora", "unetr", 1),
         # at 64 px: grids 16, 8, 4, 2 (stage 2 shifts; stage 3's window is 2)
         "unet_lora_swin": (dict(SWIN, img_size=(64, 64)), "unet_lora", "unetr_swin", 1)}
# the JAX scope of each family's encoder
SCOPES = {"mipheivit": "encoder", "unetr": "encoder_vit", "unetr_swin": "model", "hemit": "swinT"}


def _img(kw):
    return (kw["swin"] if "swin" in kw else kw)["img_size"]


def _jax_module(kw, family):
    from mipheivit_tpu.models import MipheiViT, ViTConfig as JaxCfg
    from mipheivit_tpu.models.hemit import ResnetGeneratorSwinT
    from mipheivit_tpu.models.swin import SwinConfig as JaxSwinCfg
    from mipheivit_tpu.models.unetr import UnetrSwin, UnetrViT

    if family == "unetr_swin":
        return UnetrSwin(swin_cfg=JaxSwinCfg(**kw), out_chans=OUT)
    if family == "hemit":
        rest = {k: v for k, v in kw.items() if k != "swin"}
        return ResnetGeneratorSwinT(out_channels=OUT, swin_cfg=JaxSwinCfg(**kw["swin"]), **rest)
    cfg = JaxCfg(attn_impl="xla", remat=False, **kw)
    return UnetrViT(vit_cfg=cfg, out_chans=OUT) if family == "unetr" else MipheiViT(
        vit_cfg=cfg, out_chans=OUT)


def _port_state(variables, kw, family):
    """The port's state dict of JAX ``variables`` (float or int8)."""
    if family == "unetr_swin":
        return unetr_swin_state_dict_from_jax(variables, SwinConfig(**kw))
    if family == "hemit":
        return hemit_state_dict_from_jax(variables, workers.build_generator(
            kw, OUT, device="cpu", family="hemit"))
    if family == "unetr":
        return unetr_state_dict_from_jax(variables, ViTConfig(**kw))
    return state_dict_from_jax(variables, ViTConfig(**kw), OUT)


def _jax_variables(module, kw, family, seed):
    """Seeded numpy variables (shapes from ``jax.eval_shape``; LoRA B
    non-zero) and the port's state dict of them."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda k: module.init(k, jnp.zeros((1,) + _img(kw) + (3,)),
                                                  train=False), jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)
    variables = jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(
        lambda p, t: _fill(p, t.shape, g), shapes))
    return variables, _port_state(variables, kw, family)


def _jax_int8(module, variables):
    """JAX's serving transforms: ``merge_lora`` then ``quantize_encoder``."""
    import jax

    from mipheivit_tpu.infer.loading import merge_lora, quantize_encoder

    qmodel, qvars = quantize_encoder(*merge_lora(module, variables))
    return qmodel, jax.tree.map(np.asarray, qvars)


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


def _int8_case(seed=20, m=40, k=64, n=24):
    """A row-split int8 product's operands: activations whose rows' amax
    lies in one rank's columns or the other's, and int8 codes."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((m, k)).astype(np.float32)
    x[::2, 0] = 9.0                       # rank 0's columns hold the amax
    x[1::2, -1] = -9.0                    # rank 1's
    return x, g.integers(-127, 128, (n, k), dtype=np.int8)


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
    calls, jax_work, solo_work = [], [], []
    for seed, (name, (kw, b, family, int8)) in enumerate(FORWARDS.items()):
        module = _jax_module(kw, family)
        variables, state = _jax_variables(module, kw, family, seed)
        if int8:
            module, variables = _jax_int8(module, variables)
        x = g.standard_normal((b,) + _img(kw) + (3,)).astype(np.float32)
        jax_work.append((name, lambda v, xx, module=module: module.apply(v, xx, train=False),
                         variables, x))
        out["state"][name], out["x"][name] = state, x
        calls.append((("forward", name), (workers.tp_forward,
                                          (kw, OUT, state, x, N_MODEL, family, int8))))
    calls.append((("int8", "accumulator"), (workers.tp_int8_accumulator,
                                            (*_int8_case(), N_MODEL))))
    weights = np.random.default_rng(7).uniform(1.0, 2.0, OUT).astype(np.float32)
    loss_fn = jl.weighted_mse_loss(50.0, weights)
    for seed, (key, (kw, family, arch, accum)) in enumerate(TRAIN.items(), start=10):
        module = _jax_module(kw, arch)
        variables, state = _jax_variables(module, kw, arch, seed)
        batches = _batches(_img(kw)[0], n=2 * accum, seed=seed)

        def loss(v, b, module=module):
            fake, _ = module.apply(v, b["image"], train=True, mutable=["batch_stats"])
            return loss_fn(b["target"], fake)

        jax_work.append((key, loss, variables, batches[0]))
        spec = dict(out_chans=OUT, state=state, batches=batches, weights=weights,
                    lr=1e-3, total_iters=40, warmup=2, accum=accum, family=family,
                    dtype="float64", **({"swin": kw} if arch == "unetr_swin" else {"vit": kw}))
        out["spec"][key] = spec
        tp_spec = dict(spec, n_model=N_MODEL, tp=True, return_state="rank0")
        if key == "unet_lora":
            # the moments of shard_opt_state's check come from one process
            out["solo"][key] = solo = workers.train_steps(spec)
            tp_spec["opt_ref"] = {k: v for k, v in solo["opt"].items() if _sharded(k)}
        else:
            solo_work.append((key, spec))
        calls.append((("train", key), (workers.train_steps, (tp_spec,))))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, workers.tasks, N_DATA * N_MODEL, [c for _, c in calls],
                            device="cpu", timeout=300)
        mesh = make_mesh(n_data=8 // N_MODEL, n_model=N_MODEL, devices=jax.devices()[:8])
        for name, fn, variables, arg in jax_work:
            out["jax"][name] = np.asarray(_sharded_jit(fn, mesh, variables, arg))
        for key, spec in solo_work:
            out["solo"][key] = workers.train_steps(spec)
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


def _port_model(name, state=None):
    """The port's model of ``FORWARDS[name]`` on the CPU (int8: through the
    port's ``merge_lora`` and ``quantize_encoder``)."""
    from mipheivit_tpu_torch.infer import merge_lora, quantize_encoder

    kw, _, family, int8 = FORWARDS[name]
    model = workers.build_generator(kw, OUT, state, device="cpu", family=family)
    return quantize_encoder(merge_lora(model)) if int8 else model


@pytest.mark.parametrize("name", ["gen", "unetr", "int8", "swin_unetr", "hemit"])
def test_encoder_param_specs_match_jax(name):
    """The class of every parameter (and int8 buffer) of the flagship
    generator (LoRA 2), a ViT UNETR, the generator in int8, a Swin UNETR
    and a HEMIT generator, name for name: the JAX specs, written through
    the port's converters as arrays of codes, column <=> ``"model"`` on the
    output axis, row <=> on the input axis; everything outside the encoder
    replicated on both sides; the Swin MLP and the relative-position
    tables replicated; an int8 ``scale`` column beside a column weight
    (JAX replicates it and GSPMD slices it at use), whole beside a row
    one."""
    import jax

    kw, _, family, int8 = FORWARDS[name]
    module = _jax_module(kw, family)
    variables, _ = _jax_variables(module, kw, family, 0)
    if int8:
        module, variables = _jax_int8(module, variables)
    codes = _spec_codes(variables["params"])
    outside = {k: v for k, v in codes.items() if k != SCOPES[family]}
    assert all(np.all(leaf == 1) for leaf in jax.tree.leaves(outside))
    # JAX's int8 tree is LoRA-free (merged)
    mapped = _port_state({**variables, "params": codes}, dict(kw, lora_rank=0) if int8 else kw,
                         family)
    specs = encoder_param_specs(_port_model(name))
    assert set(specs) <= set(mapped)
    classes = {1: None, 2: "column", 3: "row"}
    for key, spec in specs.items():
        arr = mapped[key]
        assert arr.min() == arr.max(), key
        want = classes[int(arr.flat[0])]
        if key.endswith(".scale"):
            assert want is None, key
            weight = specs[key[:-len("scale")] + "weight"]
            want = weight if weight == "column" else None
        assert spec == want, (key, spec, want)
    assert set(specs.values()) == {None, "column", "row"}
    if family != "hemit":
        lora = [k for k in specs if ".lora_" in k] if not int8 else []
        assert bool(lora) != int8 and all(specs[k] is None for k in lora)
    if int8:
        scales = [k for k in specs if k.endswith(".scale")]
        assert {specs[k] for k in scales} == {"column", None}
    if family in ("unetr_swin", "hemit"):
        whole = [k for k in specs if ".layers." in k and (".mlp." in k or "_table" in k)]
        assert whole and all(specs[k] is None for k in whole)


def _per_marker_pearson(a, b):
    return np.array([np.corrcoef(a[..., m].ravel(), b[..., m].ravel())[0, 1]
                     for m in range(a.shape[-1])])


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sharded_forward_matches_jax(cases, name):
    """Each rank's rows of the tensor-parallel eval forward against the JAX
    forward on its dp 4 x tp 2 mesh (int8: per-marker Pearson and max
    error, as the unsharded int8 generator is held); the two model ranks
    of a data row agree bit for bit."""
    per_rank = cases["port"]["forward", name]
    want = cases["jax"][name]
    rows = want.shape[0] // N_DATA
    for r, got in enumerate(per_rank):
        d = r // N_MODEL
        ref = want[d * rows:(d + 1) * rows]
        if FORWARDS[name][3]:
            corr = _per_marker_pearson(got, ref).min()
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert corr >= INT8_PEARSON and err <= INT8_ERR, (r, corr, err)
        else:
            np.testing.assert_allclose(got, ref, atol=MODEL_ATOL, rtol=1e-3, err_msg=f"rank {r}")
    for d in range(N_DATA):
        np.testing.assert_array_equal(per_rank[d * N_MODEL], per_rank[d * N_MODEL + 1])


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sharded_forward_matches_unsharded(cases, name):
    """The same rows against the port's own unsharded forward of the same
    weights (the plain versions of K1 or K4 and K2 at every head and the
    whole hidden width; the Swin's attention at every head)."""
    model = _port_model(name, cases["state"][name]).eval()
    with torch.no_grad():
        want = model(torch.from_numpy(cases["x"][name])).numpy()
    rows = want.shape[0] // N_DATA
    for r, got in enumerate(cases["port"]["forward", name]):
        d = r // N_MODEL
        np.testing.assert_allclose(got, want[d * rows:(d + 1) * rows], atol=UNSHARDED_TOL,
                                   rtol=UNSHARDED_TOL, err_msg=f"rank {r}")


def test_int8_row_accumulator_equals_unsharded_bit_for_bit(cases):
    """The int8 row-split product on each rank (its half of the input
    columns, the rows' scale the max over the model group, the int32
    partial sums summed over it) against the unsharded quantisation and
    int32 product: scales and accumulator bit for bit. Each row's amax lies
    in one rank's columns, so a rank quantising at its own amax would
    differ."""
    from mipheivit_tpu_torch.ops import quant

    x, w = _int8_case()
    x_i8, sx = quant.quantize_rows(torch.from_numpy(x))
    want = torch._int_mm(x_i8, torch.from_numpy(w).t().contiguous()).numpy()
    half = x.shape[1] // N_MODEL
    local = quant.quantize_rows(torch.from_numpy(x[:, :half]))[1].numpy()
    assert not np.array_equal(local, sx.numpy())
    for acc, got_sx in cases["port"]["int8", "accumulator"]:
        assert acc.dtype == np.int32
        np.testing.assert_array_equal(got_sx, sx.numpy())
        np.testing.assert_array_equal(acc, want)


@pytest.mark.parametrize("n", [2, 4])
def test_uneven_layouts_round_trip(n):
    """3 heads over n ranks (2 + 1; 1 + 1 + 1 + 0): each rank's
    ``ParallelWindowAttention`` holds ``shard_slice`` of the packed qkv and
    of the proj, which ``unshard`` puts back whole; ``shard_opt_state``
    slices whole moments to each rank's shapes and values; and the ranks'
    partial outputs (no group: each adds the bias) sum to the whole
    forward."""
    import copy

    from mipheivit_tpu_torch.models.swin import WindowAttention
    from mipheivit_tpu_torch.parallel.sharding import (ParallelWindowAttention, param_layouts,
                                                       shard_opt_state, shard_slice, split_heads,
                                                       unshard)
    from mipheivit_tpu_torch.train.optim import OptState

    torch.manual_seed(0)
    whole = torch.nn.Module()
    whole.attn = WindowAttention(24, 3, 3, lora_rank=2)
    with torch.no_grad():
        for p in whole.parameters():
            p.normal_()
    x = torch.randn(2, 9, 24, dtype=torch.float64)
    whole.double()
    with torch.no_grad():
        want = whole.attn(x)
    params = dict(whole.named_parameters())
    moments = {k: torch.randn_like(v) for k, v in params.items()}
    shards, outs = {}, []
    for r in range(n):
        ranked = copy.deepcopy(whole)
        ranked.attn = ParallelWindowAttention(ranked.attn, None, n, r)
        assert ranked.attn.num_heads == split_heads(3, n)[r]
        layouts = param_layouts(ranked)
        assert set(layouts) == {"attn.qkv.qkv.weight", "attn.qkv.qkv.bias", "attn.proj.weight"}
        for name, p in ranked.named_parameters():
            if name in layouts:
                torch.testing.assert_close(p, shard_slice(params[name], layouts[name], r),
                                           rtol=0, atol=0)
                shards.setdefault(name, []).append(p.detach())
            else:
                assert torch.equal(p, params[name]), name
        with torch.no_grad():
            outs.append(ranked.attn(x))
        state = OptState(adam_count=0, schedule_count=0,
                         mu=[moments[k] for k, p in ranked.named_parameters()],
                         nu=[2 * moments[k] for k, p in ranked.named_parameters()])
        shard_opt_state(state, ranked, Mesh(n_data=1, n_model=n, data_rank=0, model_rank=r,
                                            data_group=None, model_group=None))
        for (name, p), mu, nu in zip(ranked.named_parameters(), state.mu, state.nu):
            assert mu.shape == p.shape, name
            want_mu = (shard_slice(moments[name], layouts[name], r) if name in layouts
                       else moments[name])
            assert torch.equal(mu, want_mu) and torch.equal(nu, 2 * want_mu), name
    for name, parts in shards.items():
        assert torch.equal(unshard(parts, layouts[name]), params[name]), name
    assert shards["attn.qkv.qkv.weight"][-1].shape[0] == 3 * 8 * split_heads(3, n)[-1]
    torch.testing.assert_close(sum(outs) - (n - 1) * params["attn.proj.bias"], want)


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
        assert got["step"] == 2 * TRAIN[family][3]
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
    assert TRAIN[family][2] != "unetr_swin" or any("_table" in k for k in moved)
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


def _swin(embed_dim):
    from mipheivit_tpu_torch.models.swin import SwinTransformer

    return SwinTransformer(SwinConfig(img_size=(32, 32), embed_dim=embed_dim, depths=(1, 1),
                                      num_heads=(3, 3), window_size=4))


REJECTS = {
    "heads": (lambda: _model(num_heads=1, embed_dim=32), ValueError, "heads"),
    "hidden": (lambda: _model(mlp_hidden_dim=63), ValueError, "hidden"),
    "swin_width": (lambda: _swin(9), ValueError, "Swin stage widths"),
    "seq_shard": (lambda: _model(attn_impl="seq_shard"), ValueError, "seq_shard"),
    "no_encoder": (lambda: torch.nn.Sequential(torch.nn.Linear(4, 4)), ValueError,
                   "ViT and Swin"),
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
