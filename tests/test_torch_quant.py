"""The port's int8 W8A8 serving against the JAX package's, on the CPU.

``ops/quant.py`` (``quantize_weight``, ``int8_matmul``, ``int8_conv3x3``),
the int8 twins (``Int8Linear``, ``Int8Conv3x3``), ``quantize_encoder`` /
``quantize_decoder``, JAX's own int8 trees through ``state_dict_from_jax``,
``--seq_shard`` over 2 gloo ranks and ``run_inference --int8``.

The JAX codes are the int8 operands of JAX's ``lax.dot_general`` inside its
own functions, recorded as it runs them eagerly; the generator's int8
modules' inputs are sown by a flax method interceptor. Bounds: codes and weight
scales bit for bit; the ops' outputs within 1e-6 of max |ref| in f32 and
one bf16 step in bf16; the int8 generator against JAX's int8 forward at
per-marker Pearson >= 0.9999 and max |err| <= 1e-2 max |ref| (an f32
LayerNorm output an ulp apart at a .5 boundary flips a code; the message
counts the flipped activation codes), and against the float forward at
per-marker Pearson >= 0.995 (``tests/test_quant.py``'s gate); the int8
generator sequence-sharded over 2 ranks against JAX's unsharded int8
forward at the same bounds, and against the sharded float forward at
Pearson > 0.99 (``test_int8_with_seq_shard_serving``).
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.infer import loading as port_loading
from mipheivit_tpu_torch.models.convert import state_dict_from_jax
from mipheivit_tpu_torch.models.mipheivit import Int8Conv3x3, MipheiViT
from mipheivit_tpu_torch.models.vit import Int8Linear, ViTConfig
from mipheivit_tpu_torch.ops import quant

import torch_synthetic_run as syn

torch.set_num_threads(2)

OP_RTOL = 1e-6
MODEL_PEARSON, MODEL_ERR = 0.9999, 1e-2
FLOAT_PEARSON = 0.995
SHARD_PEARSON = 0.99
TINY = dict(img_size=(32, 32), patch_size=4, embed_dim=64, depth=2, num_heads=2,
            mlp_hidden_dim=128, reg_tokens=4, lora_rank=0)
# JAX's test_int8_with_seq_shard_serving: 64 tokens, no prefix
SHARD = dict(img_size=(32, 32), patch_size=4, embed_dim=32, depth=2, num_heads=2,
             mlp_hidden_dim=64, reg_tokens=0, class_token=False, no_embed_class=True,
             lora_rank=0)


class _DotOperands:
    """Records the first operand of every ``jax.lax.dot_general`` call (the
    int8 codes in ``ops/quant.py``) while the JAX functions run eagerly."""

    def __init__(self, monkeypatch):
        import jax

        self.codes = []
        dot = jax.lax.dot_general

        def record(a, b, *args, **kw):
            if np.dtype(a.dtype) == np.int8:
                self.codes.append(np.asarray(a))
            return dot(a, b, *args, **kw)

        monkeypatch.setattr(jax.lax, "dot_general", record)


def _bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Within one bf16 step of ``want`` (2**(e - 7) for |want| in [2**e, 2**(e+1)))."""
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return bool(((got.float() - w).abs() <= step).all())


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", ["matrix", "stacked", "bf16_values"])
def test_quantize_weight_matches_jax_bit_for_bit(case):
    """Codes and scales of JAX's ``quantize_weight`` ([..., in, out], an
    all-zero output column, a stacked leading axis, bf16-rounded values),
    and the same from the port's ``[out, in]`` layout (axis -1)."""
    from mipheivit_tpu.ops.quant import quantize_weight as jax_quantize_weight

    g = np.random.default_rng(0)
    shape = {"matrix": (96, 48), "stacked": (3, 40, 24), "bf16_values": (64, 32)}[case]
    w = (g.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 5] = 0.0
    if case == "bf16_values":
        w = torch.from_numpy(w).bfloat16().float().numpy()
    want_i8, want_scale = jax_quantize_weight(w)
    got_i8, got_scale = quant.quantize_weight(w)
    np.testing.assert_array_equal(got_i8.numpy(), want_i8)
    np.testing.assert_array_equal(got_scale.numpy(), want_scale)
    assert got_scale.dtype == torch.float32 and np.all(want_scale[..., 5] == 1.0)
    got_i8, got_scale = quant.quantize_weight(np.swapaxes(w, -1, -2), axis=-1)
    np.testing.assert_array_equal(got_i8.numpy(), np.swapaxes(want_i8, -1, -2))
    np.testing.assert_array_equal(got_scale.numpy(), want_scale)


MATMUL_CASES = {"f32": (64, 96, 48, "float32"), "bf16": (64, 96, 48, "bfloat16"),
                "zero_row": (40, 96, 48, "float32"), "m_le_16": (5, 96, 48, "float32"),
                "k_not_multiple_of_8": (33, 21, 12, "float32")}


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_int8_matmul_matches_jax(case, monkeypatch):
    """Activation codes equal to JAX's; the output of the plain version and
    of the padded route the card takes within 1e-6 of max |ref| (f32) or
    one bf16 step (bf16)."""
    import jax.numpy as jnp

    from mipheivit_tpu.ops import quant as jax_quant

    m, k, n, dt = MATMUL_CASES[case]
    g = np.random.default_rng(1)
    x = g.standard_normal((m, k)).astype(np.float32)
    if case == "zero_row":
        x[3] = 0.0
    w = (g.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = g.standard_normal(n).astype(np.float32)
    w_i8, scale = jax_quant.quantize_weight(w)
    jdt = getattr(jnp, dt)
    dots = _DotOperands(monkeypatch)
    want = np.array(jax_quant.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(w_i8),
                                            jnp.asarray(scale), jnp.asarray(b, jdt)).astype(
        jnp.float32))
    tdt = getattr(torch, dt)
    xt = torch.from_numpy(x).to(tdt)
    args = (torch.from_numpy(w_i8.T.copy()), torch.from_numpy(scale), torch.from_numpy(b).to(tdt))
    codes, _ = quant.quantize_rows(xt)
    np.testing.assert_array_equal(codes.numpy(), dots.codes[0])
    if case == "zero_row":
        assert not codes[3].any()
    for fn in (quant.int8_matmul, quant.int8_matmul_padded):
        got = fn(xt, *args)
        assert got.dtype == tdt and got.shape == (m, n)
        if dt == "float32":
            assert _rel(got.numpy(), want) <= OP_RTOL, (fn.__name__, _rel(got.numpy(), want))
        else:
            assert _bf16_close(got, torch.from_numpy(want)), fn.__name__


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_int8_conv3x3_matches_jax(dt, monkeypatch):
    """At C = 67 (the flagship's last fusion block; 9C = 603, not a
    multiple of 8): patch codes equal to JAX's; ``Int8Conv3x3``'s weight is
    JAX's flattened codes with zero columns to 608; the outputs of the plain
    version and of the padded route, on that weight and on the unpadded
    one, within the op bounds."""
    import jax.numpy as jnp

    from mipheivit_tpu.models.mipheivit import flatten_conv3x3_kernel
    from mipheivit_tpu.ops import quant as jax_quant

    g = np.random.default_rng(2)
    x = g.standard_normal((2, 12, 16, 67)).astype(np.float32)
    x[0, 3:6, 4:9] = 0.0                       # zero pixels: windows with amax 0 only inside
    kernel = (g.standard_normal((3, 3, 67, 32)) * 0.05).astype(np.float32)
    w_i8, scale = jax_quant.quantize_weight(np.asarray(flatten_conv3x3_kernel(kernel)))
    jdt = getattr(jnp, dt)
    dots = _DotOperands(monkeypatch)
    want = np.array(jax_quant.int8_conv3x3(jnp.asarray(x, jdt), jnp.asarray(w_i8),
                                             jnp.asarray(scale)).astype(jnp.float32))
    tdt = getattr(torch, dt)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)        # NCHW, channels_last memory
    codes, _ = quant.quantize_patches(xt)
    np.testing.assert_array_equal(codes.numpy(), dots.codes[0])
    conv = torch.nn.Conv2d(67, 32, 3, bias=False)
    conv.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    twin = Int8Conv3x3.from_conv(conv)
    assert twin.weight.shape == (32, quant.patch_width(67)) == (32, 608)
    np.testing.assert_array_equal(twin.weight[:, :603].numpy(), w_i8.T)
    assert not twin.weight[:, 603:].any()
    np.testing.assert_array_equal(twin.scale.numpy(), scale)
    unpadded = torch.from_numpy(w_i8.T.copy())
    for fn, w in [(fn, w) for fn in (quant.int8_conv3x3, quant.int8_conv3x3_padded)
                  for w in (twin.weight, unpadded)]:
        got = fn(xt, w, twin.scale)
        assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
        got = got.permute(0, 2, 3, 1)
        if dt == "float32":
            assert _rel(got.numpy(), want) <= OP_RTOL, (fn.__name__, _rel(got.numpy(), want))
        else:
            assert _bf16_close(got, torch.from_numpy(want)), fn.__name__


def _fill(path, shape, g):
    """A plausible value for a JAX variable (``tests/test_torch_seq_shard.py``'s)."""
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


def _jax_variables(model, kw, seed):
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1,) + kw["img_size"] + (3,)),
                                                 train=False), jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)
    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(
        lambda p, t: _fill(p, t.shape, g), shapes))


@pytest.fixture(scope="module", params=["swiglu", "gelu"])
def generators(request):
    """A depth-2 MipheiViT of each MLP type: the JAX f32 forward, the JAX
    transforms' int8 forward (eager; the int8 modules' float inputs sown by
    a method interceptor), and the port's: quantised by its own transforms
    and loaded from JAX's int8 tree."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.infer.loading import quantize_decoder, quantize_encoder
    from mipheivit_tpu.models import MipheiViT as JaxMipheiViT
    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu.models.mipheivit import _Int8Im2ColConv
    from mipheivit_tpu.models.vit import Int8Dense

    kw = dict(TINY, mlp_type=request.param)
    jmodel = JaxMipheiViT(vit_cfg=JaxViTConfig(attn_impl="xla", remat=False, scan_blocks=False,
                                               **kw), out_chans=4)
    variables = _jax_variables(jmodel, kw, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want_f32 = np.asarray(jax.jit(lambda v, t: jmodel.apply(v, t, train=False))(
        variables, jnp.asarray(x)))
    qmodel, qvars = quantize_decoder(*quantize_encoder(jmodel, variables))
    qvars = jax.tree.map(np.asarray, qvars)

    def sow_input(next_fun, args, kwargs, context):
        if isinstance(context.module, (Int8Dense, _Int8Im2ColConv)) and \
                context.method_name == "__call__":
            context.module.sow("intermediates", "int8_input", args[0])
        return next_fun(*args, **kwargs)

    def int8_forward(v, t):
        with nn.intercept_methods(sow_input):
            return qmodel.apply(v, t, train=False, mutable=["intermediates"])

    # eagerly, op by op: under jit XLA's fusions move the f32 LayerNorm and
    # GELU outputs by an ulp often enough to flip ~1% of the decoder's codes
    want_int8, sown = int8_forward(qvars, jnp.asarray(x))
    sown = sown["intermediates"]
    paths = [("encoder", "vit", f"blocks_{i}", *p) for i in range(kw["depth"])
             for p in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2"))]
    paths += [("decoder", f"fusion_blks_{j}", "conv", "conv") for j in range(4)]
    jax_inputs = []
    for path in paths:
        node = sown
        for key in path:
            node = node[key]
        jax_inputs.append(np.asarray(node["int8_input"][0]))
    want_int8 = np.asarray(want_int8)

    def port(state, quantize_first=False):
        model = MipheiViT(ViTConfig(**kw), out_chans=4).eval()
        if quantize_first:
            port_loading.quantize_decoder(port_loading.quantize_encoder(model))
        port_loading.load_strict(model, {k: torch.from_numpy(np.array(v))
                                         for k, v in state.items()})
        return model

    own = port_loading.quantize_decoder(port_loading.quantize_encoder(
        port(state_dict_from_jax(variables, ViTConfig(**kw), 4))))
    carried = port(state_dict_from_jax(qvars, ViTConfig(**kw), 4), quantize_first=True)
    return {"x": x, "f32": want_f32, "int8": want_int8, "jax_inputs": jax_inputs,
            "jax_tree": qvars, "own": own, "carried": carried}


def _forward_recording(model, x):
    """The port's forward on ``x`` and the float inputs of its int8 modules,
    in call order (NHWC for the convs, as JAX's)."""
    inputs = []

    def hook(module, args):
        a = args[0]
        inputs.append((a.permute(0, 2, 3, 1) if isinstance(module, Int8Conv3x3) else a).numpy())

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (Int8Linear, Int8Conv3x3))]
    try:
        with torch.inference_mode():
            out = model(torch.from_numpy(x)).numpy()
    finally:
        for h in handles:
            h.remove()
    return out, inputs


def _codes(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if t.ndim == 4:                                # NHWC conv input
        return quant.quantize_patches(t.permute(0, 3, 1, 2))[0]
    return quant.quantize_rows(t.reshape(-1, t.shape[-1]))[0]


def _per_marker_pearson(a, b):
    return np.array([np.corrcoef(a[..., m].ravel(), b[..., m].ravel())[0, 1]
                     for m in range(a.shape[-1])])


@pytest.mark.parametrize("route", ["own_transforms", "jax_int8_tree"])
def test_int8_generator_matches_jax_int8(generators, route):
    """The port's int8 generator against JAX's int8 forward: quantised by
    the port's transforms (weight codes and scales equal to those of JAX's
    tree) or loaded from JAX's int8 tree; and against the f32 forward."""
    model = generators["own" if route == "own_transforms" else "carried"]
    if route == "own_transforms":
        carried = generators["carried"].state_dict()
        for name, t in model.state_dict().items():
            if t.dtype == torch.int8 or name.endswith(".scale"):
                assert torch.equal(t, carried[name]), name
    got, inputs = _forward_recording(model, generators["x"])
    want = generators["int8"]
    assert len(inputs) == len(generators["jax_inputs"]) == 4 * 2 + 4
    flips = sum(int((_codes(a) != _codes(b)).sum())
                for a, b in zip(inputs, generators["jax_inputs"]))
    n_codes = sum(_codes(a).numel() for a in inputs)
    r = _per_marker_pearson(got, want)
    err = np.abs(got - want).max() / np.abs(want).max()
    msg = (f"per-marker Pearson min {r.min():.6f}, max |err| {err:.2e} of max |ref|, "
           f"{flips} of {n_codes} activation codes flipped")
    assert r.min() >= MODEL_PEARSON and err <= MODEL_ERR, msg
    r32 = _per_marker_pearson(got, generators["f32"])
    assert r32.min() >= FLOAT_PEARSON, (r32, msg)


@pytest.mark.parametrize("case", ["no_vit_encoder", "live_lora", "decoder_not_flagship"])
def test_quantize_refuses_what_it_cannot_quantise(case):
    """``quantize_encoder`` raises ``ValueError`` on a model without a ViT
    encoder (as JAX's) and on live LoRA adapters (merge first);
    ``quantize_decoder`` on a model other than the flagship."""
    from mipheivit_tpu_torch.models.vit import VisionTransformer

    if case == "no_vit_encoder":
        with pytest.raises(ValueError, match="ViT-encoder"):
            port_loading.quantize_encoder(VisionTransformer(ViTConfig(**TINY)))
    elif case == "live_lora":
        model = MipheiViT(ViTConfig(**{**TINY, "lora_rank": 4}), out_chans=2)
        with pytest.raises(ValueError, match="merge_lora"):
            port_loading.quantize_encoder(model)
        port_loading.quantize_encoder(port_loading.merge_lora(model))
        assert isinstance(model.encoder.vit.blocks[0].attn.qkv, Int8Linear)
    else:
        with pytest.raises(ValueError, match="MipheiViT"):
            port_loading.quantize_decoder(VisionTransformer(ViTConfig(**TINY)))


def test_int8_with_seq_shard_over_two_ranks():
    """W8A8 and sequence-sharded attention together, over 2 gloo ranks: the
    port's int8 generator, quantised by its own transforms and loaded from
    JAX's int8 tree, against JAX's int8 forward of the same variables
    (unsharded, eager; per-marker Pearson >= 0.9999, max |err| <= 1e-2 max
    |ref|) and against the port's float forward sharded the same way
    (Pearson > 0.99, as ``tests/test_quant.py``); both ranks identical."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.infer.loading import quantize_decoder, quantize_encoder
    from mipheivit_tpu.models import MipheiViT as JaxMipheiViT
    from mipheivit_tpu.models import ViTConfig as JaxViTConfig
    from mipheivit_tpu_torch.parallel import workers
    from mipheivit_tpu_torch.parallel.spawn import spawn

    jmodel = JaxMipheiViT(vit_cfg=JaxViTConfig(attn_impl="xla", remat=False, **SHARD),
                          out_chans=2)
    variables = _jax_variables(jmodel, SHARD, seed=5)
    x = np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)
    qmodel, qvars = quantize_decoder(*quantize_encoder(jmodel, variables))
    want = np.asarray(qmodel.apply(jax.tree.map(np.asarray, qvars), jnp.asarray(x),
                                   train=False))
    state = state_dict_from_jax(variables, ViTConfig(**SHARD), 2)
    int8_state = state_dict_from_jax(jax.tree.map(np.asarray, qvars), ViTConfig(**SHARD), 2)
    calls = [(workers.forward, (SHARD, 2, state, x)),
             (syn.int8_forward, (SHARD, 2, state, x)),
             (syn.int8_forward, (SHARD, 2, None, x, int8_state))]
    ranks = spawn(workers.tasks, 2, calls, device="cpu", timeout=240)
    for got0, got1 in zip(*ranks):
        np.testing.assert_array_equal(got1, got0)
    ref, own, carried = ranks[0]
    for name, out in (("own_transforms", own), ("jax_int8_tree", carried)):
        r = _per_marker_pearson(out, want)
        err = np.abs(out - want).max() / np.abs(want).max()
        msg = f"{name}: per-marker Pearson min {r.min():.6f}, max |err| {err:.2e} of max |ref|"
        assert r.min() >= MODEL_PEARSON and err <= MODEL_ERR, msg
        assert np.abs(out - ref).max() > 0                  # the int8 twin ran
        assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > SHARD_PEARSON, msg


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A synthetic run (``tests/torch_synthetic_run.py``) with a checkpoint
    dir holding its ``config.yaml`` and a 104 x 88 H&E slide."""
    from mipheivit_tpu_torch.config import compose, save_config
    from mipheivit_tpu_torch.slideio import write_pyramid

    root = tmp_path_factory.mktemp("int8_cli")
    values = syn.write_run(root)
    ckpt = syn.write_checkpoint(root).parent
    cfg = syn.configure(compose(["+default_configs=miphei-vit"]), values)
    save_config(cfg, ckpt / "config.yaml")
    slide = root / "slide.tiff"
    he = np.random.default_rng(7).integers(60, 255, (3, 88, 104), dtype=np.uint8)
    write_pyramid(str(slide), he, n_levels=2, tile_size=32)
    return ckpt, slide


def _read_slide(path):
    from mipheivit_tpu_torch.slideio import TiffSlide

    ts = TiffSlide(str(path))
    try:
        return ts.read_region((0, 0), 0, ts.dimensions).astype(np.int16)
    finally:
        ts.close()


@pytest.mark.parametrize("mode", ["wsi", "wsi_seq_shard", "tiles"])
def test_run_inference_cli_int8(run_dir, mode, monkeypatch, caplog):
    """``--wsi ... --int8`` quantises the loaded generator (encoder, then
    decoder) and writes a slide within a few codec steps of the float one
    (``tests/test_quant.py::test_int8_wsi_serving_path``'s bounds); with
    ``--seq_shard`` on 2 gloo ranks (the torchrun layout) rank 0 writes a
    slide within one uint8 step of the one-process int8 CLI's; tile mode
    with ``--int8`` writes the same TIFFs as without it and logs that the
    flag applies to ``--wsi``, as the JAX CLI ignores it there."""
    from mipheivit_tpu_torch import run_inference

    ckpt, slide = run_dir
    monkeypatch.setattr(port_loading, "get_generator", syn.tiny_generator)
    calls = []
    for name in ("quantize_encoder", "quantize_decoder"):
        real = getattr(port_loading, name)
        monkeypatch.setattr(port_loading, name,
                            lambda m, real=real, name=name: calls.append(name) or real(m))
    base = ["--checkpoint_dir", str(ckpt), "--device", "cpu"]
    if mode == "wsi_seq_shard":
        from mipheivit_tpu_torch.parallel.spawn import spawn

        base += ["--wsi", str(slide), "--tile_size", "32", "--overlap", "8", "--int8"]
        sharded = str(ckpt.parent / "q_sharded.ome.tiff")
        out = spawn(syn.cli, 2, ("run_inference", base + ["--out", sharded, "--seq_shard"],
                                 syn.TINY), device="cpu", timeout=240)
        assert out == [sharded, None]
        solo = run_inference.main(base + ["--out", str(ckpt.parent / "q_solo.ome.tiff")])
        got, want = _read_slide(sharded), _read_slide(solo)
        assert got.shape == want.shape == (88, 104, 2) and got.any()
        assert np.abs(got - want).max() <= 1
    elif mode == "wsi":
        base += ["--wsi", str(slide), "--tile_size", "32", "--overlap", "8"]
        f32 = _read_slide(run_inference.main(base + ["--out", str(ckpt.parent / "f.ome.tiff")]))
        assert calls == []
        q = _read_slide(run_inference.main(base + ["--out", str(ckpt.parent / "q.ome.tiff"),
                                                   "--int8"]))
        assert calls == ["quantize_encoder", "quantize_decoder"]
        assert q.shape == f32.shape == (88, 104, 2) and q.any()
        diff = np.abs(q - f32)
        assert diff.max() > 0 and np.median(diff) <= 1 and np.mean(diff <= 10) > 0.99
    else:
        out_dir = Path(run_inference.main(base))
        files = sorted(out_dir.glob("*.tiff"))
        want = {p.name: p.read_bytes() for p in files}
        for p in files:
            p.unlink()
        with caplog.at_level(logging.WARNING, logger="mipheivit_tpu_torch.run_inference"):
            assert Path(run_inference.main(base + ["--int8"])) == out_dir
        assert calls == []
        assert any("--int8 applies to --wsi" in r.getMessage() for r in caplog.records)
        assert len(want) == 2 and {p.name: p.read_bytes() for p in files} == want
