"""Sequence-sharded attention and whole-region encoding over gloo ranks on
the CPU, against the JAX package's ``parallel.seq`` on the 8-device CPU
mesh of ``tests/conftest.py``.

The port's ranks are processes (``parallel.spawn``) that run the plain
versions of K1, K4 and K5; the JAX side shards over a ``make_mesh(1, n)``
mesh. One spawn per rank count runs every case of this file
(``parallel.workers.tasks``). Tolerances: the attention output 1e-5 in
f32, its gradients 1e-4 of their norm; the ViT and the generator 5e-4 (the
setup of ``tests/test_seq_shard.py``); the stitched WSI one uint8 step.
"""

import os

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models.convert import state_dict_from_jax
from mipheivit_tpu_torch.parallel import workers
from mipheivit_tpu_torch.parallel.spawn import spawn

torch.set_num_threads(2)


def _threads() -> int:
    """A rank's intra-op thread count, reported when an output is off."""
    return torch.get_num_threads()

HEADS = 2                    # heads of 32: H*D = 64
OUT_ATOL = 1e-5
GRAD_NORM_RTOL = 1e-4
MODEL_ATOL = 5e-4
# one fused input, and its q, k, v as separate inputs; neither 4 nor 2
# divides 201
ATTN_S = 201
ATTN_CASES = [(n, fused) for n in (2, 4) for fused in (True, False)]
GEN = dict(img_size=(256, 256), patch_size=16, embed_dim=64, depth=2, num_heads=2,
           mlp_hidden_dim=128, reg_tokens=4, no_embed_class=True, lora_rank=4)   # 260 tokens
WSI_VIT = dict(img_size=(64, 64), patch_size=4, embed_dim=32, depth=2, num_heads=2,
               mlp_hidden_dim=64, reg_tokens=0, class_token=False, no_embed_class=True,
               lora_rank=0)                                # 256 tokens a window
WSI_KW = dict(tile_size=64, overlap=16, batch_size=2, tissue_only=False)
MEAN, STD = [180.0] * 3, [40.0] * 3
NAMES = ["CD31", "CD3e"]


def _fill(path, shape, g):
    """A plausible value for a JAX variable: weights ~ N(0, 1/fan_in),
    norm scales near 1, running variances in [0.5, 1.5], the rest small."""
    name = "/".join(str(getattr(k, "key", k)) for k in path)
    if name.endswith("scale") or name.endswith("gamma"):
        return (1.0 + 0.1 * g.standard_normal(shape)).astype(np.float32)
    if name.endswith("var"):
        return g.uniform(0.5, 1.5, shape).astype(np.float32)
    if name.endswith(("ls1", "ls2")):
        return g.uniform(0.05, 0.15, shape).astype(np.float32)
    if len(shape) < 2 or name.endswith(("pos_embed", "cls_token", "reg_token")):
        return (0.05 * g.standard_normal(shape)).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (g.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _jax_model(kw, out_chans, seed):
    """A JAX MipheiViT with ``attn_impl="xla"``, seeded variables (shapes
    from ``jax.eval_shape``: no compile) and the port's state dict of
    them."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models import MipheiViT, ViTConfig
    from mipheivit_tpu_torch.models.vit import ViTConfig as PortCfg

    model = MipheiViT(vit_cfg=ViTConfig(attn_impl="xla", remat=False, **kw), out_chans=out_chans)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1,) + kw["img_size"] + (3,)),
                                                 train=False), jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(lambda p, t: _fill(p, t.shape, g), shapes)
    variables = jax.tree.map(np.asarray, variables)
    return model, variables, state_dict_from_jax(variables, PortCfg(**kw), out_chans)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's inputs, the JAX reference and the port's results at 2
    and at 4 ranks."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.data.stats import Normalizer
    from mipheivit_tpu.infer import wsi_inference as jax_wsi
    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu.models import VisionTransformer as JaxViT
    from mipheivit_tpu.parallel import make_mesh
    from mipheivit_tpu.parallel.seq import seq_sharded_attention as jax_seq
    from mipheivit_tpu.slideio import TiffSlide, write_pyramid

    g = np.random.default_rng(3)
    out = {"jax": {}}
    calls = {2: [], 4: []}
    mesh = make_mesh(n_data=1, n_model=4, devices=jax.devices()[:4])
    qkv = g.standard_normal((2, ATTN_S, 3 * 64)).astype(np.float32)

    def loss(t):
        o = jax_seq(t, num_heads=HEADS, mesh=mesh)
        return jnp.sum(o ** 2), o

    (_, o), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(qkv))
    grad = np.asarray(grad)
    out["jax"][True] = (np.asarray(o), [grad])
    out["jax"][False] = (np.asarray(o), list(np.split(grad, 3, axis=-1)))
    for n in (2, 4):
        calls[n].append((("threads",), n, (_threads, ())))
        calls[n].append((("attn", True), n, (workers.seq_attention, (qkv, None, None, HEADS))))
        calls[n].append((("attn", False), n, (workers.seq_attention,
                                               (*np.split(qkv, 3, axis=-1), HEADS))))

    gen, gen_vars, gen_state = _jax_model(GEN, 2, seed=1)
    x = jnp.asarray(g.standard_normal((2, 256, 256, 3)).astype(np.float32))
    out["gen_x"] = np.asarray(jax.jit(lambda v, x: gen.apply(v, x, train=False))(gen_vars, x))
    vit = JaxViT(JaxViTConfig(attn_impl="xla", remat=False, **GEN))
    out["vit_x"] = np.asarray(jax.jit(vit.apply)(
        {"params": gen_vars["params"]["encoder"]["vit"]}, x))
    vit_state = {k[len("encoder.vit."):]: v for k, v in gen_state.items()
                 if k.startswith("encoder.vit.")}
    x = np.asarray(x)
    wsi, wsi_vars, wsi_state = _jax_model(WSI_VIT, 2, seed=2)
    image = g.integers(100, 255, (128, 128, 3)).astype(np.uint8)
    out["image"] = image
    norm = Normalizer({"mean": MEAN, "std": STD}, "he")
    slide = tmp_path_factory.mktemp("wsi") / "s.tiff"
    write_pyramid(str(slide), image.transpose(2, 0, 1).copy(), n_levels=2, tile_size=64)
    pred = str(slide.with_suffix(".pred.ome.tiff"))
    jax_wsi(wsi, wsi_vars, str(slide), pred, NAMES, norm, n_pyramid_levels=2, **WSI_KW)
    ts = TiffSlide(pred)
    out["wsi_jax"] = ts.read_region((0, 0), 0, ts.dimensions).transpose(2, 0, 1)
    ts.close()
    out["wsi_state"] = wsi_state
    calls[2] += [("vit", 2, (workers.forward, (GEN, None, vit_state, x))),
                 ("gen", 2, (workers.forward, (GEN, 2, gen_state, x))),
                 ("wsi", 2, (workers.wsi, (WSI_VIT, 2, wsi_state, image, NAMES, MEAN, STD,
                                           WSI_KW)))]
    calls[4] += [("vit", 4, (workers.forward, (GEN, None, vit_state, x))),
                 ("vit_dp", 4, (workers.forward, (GEN, None, vit_state, x, 2)))]
    out["port"] = {}
    for n, items in calls.items():
        results = spawn(workers.tasks, n, [c for _, _, c in items], device="cpu", timeout=240)
        for (tag, key, _), *per_rank in zip(items, *results):
            out["port"][(*tag, key) if isinstance(tag, tuple) else (tag, key)] = per_rank
    return out


@pytest.mark.parametrize("n,fused", ATTN_CASES, ids=[
    f"{n}ranks_{'fused' if fused else 'qkv'}" for n, fused in ATTN_CASES])
def test_seq_sharded_attention_matches_jax(cases, n, fused):
    """Output and gradients of ``sum(out**2)`` at 2 and 4 ranks (S = 201:
    padded) against the JAX function on a 4-device model axis; every rank
    holds the same gathered output."""
    want_out, want_grads = cases["jax"][fused]
    per_rank = cases["port"]["attn", fused, n]
    assert len(per_rank) == n
    got_out, got_grads = per_rank[0]
    err = np.abs(got_out - want_out)
    worst = tuple(int(i) for i in np.unravel_index(np.argmax(err), err.shape))
    np.testing.assert_allclose(got_out, want_out, atol=OUT_ATOL, rtol=0, err_msg=(
        f"worst element {worst}: port {float(got_out[worst])!r}, "
        f"JAX {float(want_out[worst])!r}; "
        f"{int((err > OUT_ATOL).sum())} of {err.size} off; intra-op threads by rank "
        f"{cases['port']['threads', n]}, this process {torch.get_num_threads()}; "
        f"{len(os.sched_getaffinity(0))} cores, load {os.getloadavg()}"))
    for other_out, _ in per_rank[1:]:
        np.testing.assert_array_equal(other_out, got_out)
    assert len(got_grads) == len(want_grads)
    for got, want in zip(got_grads, want_grads):
        assert np.linalg.norm(got - want) <= GRAD_NORM_RTOL * np.linalg.norm(want)


@pytest.mark.parametrize("n", [2, 4])
def test_vit_seq_shard_matches_jax_xla(cases, n):
    """The 2-block ViT (LoRA live, register tokens; 260 tokens), sharded
    over n ranks, equals the JAX ``attn_impl="xla"`` forward on the same
    weights."""
    per_rank = cases["port"]["vit", n]
    for got in per_rank:
        np.testing.assert_allclose(got, cases["vit_x"], atol=MODEL_ATOL, rtol=1e-3)


def test_vit_seq_shard_over_a_data_by_model_mesh(cases):
    """4 ranks as 2 x 2: each data rank's model group encodes its row."""
    per_rank = cases["port"]["vit_dp", 4]
    want = cases["vit_x"]
    for r, got in enumerate(per_rank):
        np.testing.assert_allclose(got, want[r // 2:r // 2 + 1], atol=MODEL_ATOL, rtol=1e-3)


def test_generator_seq_shard_matches_jax_xla(cases):
    """The MipheiViT (LoRA live, register tokens) with its ViT sharded over
    2 ranks: the gathered tokens feed the decoder on every rank."""
    for got in cases["port"]["gen", 2]:
        np.testing.assert_allclose(got, cases["gen_x"], atol=MODEL_ATOL, rtol=1e-3)


def test_wsi_seq_shard_stitch_matches_unsharded_and_jax(cases):
    """Rank 0 stitches what every rank computed in lockstep; the other rank
    writes nothing. Within one uint8 step of the port's unsharded stitch
    and of the JAX function's."""
    from mipheivit_tpu_torch.data.stats import Normalizer
    from mipheivit_tpu_torch.infer.wsi import ArraySlide, wsi_inference

    got, other = cases["port"]["wsi", 2]
    assert other is None and got.shape == (2, 128, 128)
    model = workers.build_generator(WSI_VIT, 2, cases["wsi_state"], device="cpu").eval()
    solo = np.zeros_like(got)
    wsi_inference(model, ArraySlide(cases["image"]), solo, NAMES,
                  Normalizer({"mean": MEAN, "std": STD}, "he"), **WSI_KW)
    assert np.abs(got.astype(int) - solo.astype(int)).max() <= 1
    assert np.abs(got.astype(int) - cases["wsi_jax"].astype(int)).max() <= 1
    assert got.any()


def test_seq_shard_requires_scope():
    from mipheivit_tpu_torch.models.vit import ViTConfig, VisionTransformer

    vit = VisionTransformer(ViTConfig(img_size=(64, 64), patch_size=16, embed_dim=32, depth=1,
                                      num_heads=2, mlp_hidden_dim=64, reg_tokens=0,
                                      class_token=False, attn_impl="seq_shard"))
    with pytest.raises(RuntimeError, match="seq_shard_scope"):
        vit(torch.zeros(1, 64, 64, 3))


def test_seq_shard_wsi_needs_a_sharded_model():
    from mipheivit_tpu_torch.infer.wsi import ArraySlide, wsi_inference
    from mipheivit_tpu_torch.parallel.mesh import Mesh

    model = workers.build_generator(WSI_VIT, 2, device="cpu").eval()
    mesh = Mesh(n_data=1, n_model=1, data_rank=0, model_rank=0, data_group=None,
                model_group=None)
    with pytest.raises(ValueError, match="seq_shard"):
        wsi_inference(model, ArraySlide(np.zeros((64, 64, 3), np.uint8)),
                      np.zeros((2, 64, 64), np.uint8), NAMES, type("N", (), {
                          "mean": MEAN, "std": STD, "mode": "he"})(), seq_shard_mesh=mesh,
                      **WSI_KW)
