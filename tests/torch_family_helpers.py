"""Shared pieces of the tests that hold the port's baseline generators
(``test_torch_cnn.py``, ``test_torch_unetr.py``, ``test_torch_smp_unet.py``,
``test_torch_train_families*.py``, ``test_torch_trainer_families.py``)
against the JAX package: seeded JAX variables moved off their init, loading
mapped weights into a port module, the scaled comparison, tiny generators
of each family in both packages, and one train step against JAX's."""

import numpy as np
import torch


def perturbed(variables, seed):
    """numpy variables with every BatchNorm's running statistics and every
    1-D parameter moved off its init (mean ~ N(0, 0.1), var ~ U(0.5, 1.5),
    scales ~ U(0.9, 1.1), shifts ~ N(0, 0.02), layer scales ~ U(0.05,
    0.15)) and the heads' kernels scaled up."""
    import jax

    g = np.random.default_rng(seed)

    def move(path, leaf):
        leaf = np.asarray(leaf)
        name = str(path[-1].key)
        if name == "kernel" and any(t in str(k.key) for k in path for t in ("head", "_out")):
            # the heads' N(0, 0.02) init leaves tanh near 0; at N(0, 0.5)
            # the outputs span the range the markers use
            return leaf * np.float32(25.0)
        if name == "mean":
            return (g.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        if name == "var":
            return g.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if leaf.ndim == 1 and name == "scale":
            return g.uniform(0.9, 1.1, leaf.shape).astype(np.float32)
        if leaf.ndim == 1 and name == "bias":
            return (g.standard_normal(leaf.shape) * 0.02).astype(np.float32)
        if name == "gamma":
            return g.uniform(0.05, 0.15, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(move, variables)


# the JAX modules whose kernels start at N(0, 0.02) (the pix2pix ``conv_init``
# of the decoders and heads); the others' at flax's default, N(0, 1 / fan_in)
_CONV_INIT_SCOPES = ("decoder", "feature_upsampler", "convsteam", "segmentation_head",
                     "foreground_head")


def init_jax(module, x, seed=0, **kw):
    """Seeded numpy variables of ``module`` at its ``init``'s shapes (traced
    with ``jax.eval_shape``, nothing compiled): kernels at their flax init
    scale, tokens and position embeddings N(0, 0.02), layer scales U(0.05,
    0.15), then ``perturbed``."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw))
    g = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(k.key) for k in path]
        shape = leaf.shape
        if names[-1] in ("ls1", "ls2"):
            return g.uniform(0.05, 0.15, shape).astype(np.float32)
        if len(shape) >= 2 and names[-1] not in ("pos_embed", "cls_token", "reg_token"):
            if any(t in n for n in names for t in _CONV_INIT_SCOPES):
                std = 0.02
            else:
                std = 1.0 / np.sqrt(max(int(np.prod(shape[:-1])), 1))
            return (g.standard_normal(shape) * std).astype(np.float32)
        if names[-1] == "var":
            return np.ones(shape, np.float32)
        return (g.standard_normal(shape) * 0.02).astype(np.float32)

    return perturbed(jax.tree_util.tree_map_with_path(fill, shapes), seed + 1)


def apply_jax(module, variables, x, **kw):
    """``module.apply(variables, x, **kw)`` compiled once (faster than
    op-by-op dispatch for these graphs)."""
    import functools

    import jax

    return jax.jit(functools.partial(module.apply, **kw))(variables, x)


def load(model, state, prefix=""):
    state = {k[len(prefix):]: torch.from_numpy(np.array(v)) for k, v in state.items()
             if k.startswith(prefix)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return model


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, (err, tol * scale)


# ---------------------------------------------------------------------------
# tiny generators of each family in both packages (the training tests)

OUT, DEPTH = 2, 4
DIMS, DEPTHS, DECODER = (8, 16, 24, 32), (1, 1, 2, 1), (16, 8, 8, 8, 8)


def vit_cfgs(lora_rank, img=64, dtype="float32"):
    """(JAX ViTConfig, port ViTConfig) of a tiny encoder: width 64, one head
    of 64, depth ``DEPTH``, patch 16, 4 register tokens."""
    from mipheivit_tpu.models.vit import ViTConfig as JC
    from mipheivit_tpu_torch.models.vit import ViTConfig

    kw = dict(img_size=(img, img), patch_size=16, embed_dim=64, depth=DEPTH, num_heads=1,
              mlp_hidden_dim=128, reg_tokens=4, lora_rank=lora_rank)
    return JC(attn_impl="xla", remat=False, dtype=dtype, **kw), ViTConfig(**kw)


def family(model_name, fg=False, img=64, dtype="float32"):
    """(JAX module, port module, JAX-to-port state-dict map) of a tiny
    generator of ``model_name``; ``dtype`` is the JAX module's compute
    dtype."""
    from mipheivit_tpu_torch.models.convert import (smp_unet_state_dict_from_jax,
                                                    unet_resnet50_state_dict_from_jax,
                                                    unetr_state_dict_from_jax)
    from mipheivit_tpu_torch.models.smp_unet import UnetMultiHeads
    from mipheivit_tpu_torch.models.unetr import UnetrViT
    from mipheivit_tpu_torch.models.vit import ViTConfig

    if model_name.startswith("smp_unet"):
        from mipheivit_tpu.models.smp_unet import UnetMultiHeads as JU

        kw = dict(encoder_name="tu-convnext_large", out_chans=OUT, decoder_channels=DECODER,
                  foreground_head=fg, encoder_dims=DIMS, encoder_depths=DEPTHS)
        return JU(dtype=dtype, **kw), UnetMultiHeads(**kw), smp_unet_state_dict_from_jax
    if model_name == "unet_resnet50":
        from mipheivit_tpu.models.cnn import UnetResnet50 as JR
        from mipheivit_tpu_torch.models.cnn import UnetResnet50

        return JR(out_chans=OUT), UnetResnet50(out_chans=OUT), unet_resnet50_state_dict_from_jax
    from mipheivit_tpu.models.unetr import UnetrViT as JU

    jcfg, pcfg = vit_cfgs(8 if "lora" in model_name else 0, img, dtype)
    return (JU(vit_cfg=jcfg, out_chans=OUT), UnetrViT(pcfg, out_chans=OUT),
            lambda v: unetr_state_dict_from_jax(v, pcfg))


def family_variables(jmodel, img=64, seed=0):
    """Seeded JAX variables of ``jmodel`` (``perturbed``), LoRA B non-zero."""
    x = np.zeros((2, img, img, 3), np.float32)
    v = init_jax(jmodel, x, seed, train=False)
    vit = v["params"].get("encoder_vit")
    if vit is not None and "lora_q" in vit["blocks"]["attn"]:
        g = np.random.default_rng(seed + 9)
        for lq in ("lora_q", "lora_v"):
            b = vit["blocks"]["attn"][lq]["B"]
            vit["blocks"]["attn"][lq]["B"] = (g.standard_normal(b.shape) * 0.05).astype(np.float32)
    return v


# ---------------------------------------------------------------------------
# one train step of a tiny generator against JAX's make_train_step

LR = 1e-3
# losses: the same math in another order
LOSS_RTOL = 1e-4
# parameters after two updates, in norm relative to the JAX update, over the
# tensors whose gradient is not zero in exact arithmetic
UPDATE_NORM_RTOL = 1e-2
# a gradient that is zero in exact arithmetic (a conv bias ahead of a
# training BatchNorm) is noise on both sides: Adam turns it into a full step
# of either sign, so such a tensor may differ by two steps per element
GRAD_FLOOR, STEP_SLACK = 1e-6, 2.0
# BatchNorm running statistics (the heads' variances reach ~15 on these
# weights, hence a relative term too)
STAT_ATOL, STAT_RTOL = 1e-5, 1e-5


def _batches(n, img=64):
    g = np.random.default_rng(6)
    # targets at the low end of the range too, so the fg target has both classes
    return [{"image": g.standard_normal((2, img, img, 3)).astype(np.float32),
             "target": g.uniform(-0.9, 0.9, (2, img, img, OUT)).astype(np.float32)}
            for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def train_step_matches_jax(model_name, gan, fg, monkeypatch):
    """One train step of the tiny ``model_name`` generator (with the GAN,
    with the foreground head) against JAX's ``make_train_step`` from the
    same weights with dropout 0: two microbatches (two optimizer steps, the
    first a zero update), every loss of each, BatchNorm running statistics
    and every trainable tensor after the second update.

    The models run in f64 on both sides (the optimizers keep their f32 and
    f64 moments): at these sizes the decoder's training BatchNorms see
    128-2048 values a channel, and normalising by their batch statistics
    turns f32 rounding into gradient differences of 0.5-1.4 % in some
    tensors (measured against JAX, 64 and 128 px), which Adam passes on."""
    import jax

    with jax.enable_x64(True):
        _train_step(model_name, gan, fg, monkeypatch)


def _train_step(model_name, gan, fg, monkeypatch):
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.metrics import PixelMetrics as JM
    from mipheivit_tpu.models.discriminator import DiscriminatorPatch as JD
    from mipheivit_tpu.train import losses as jl
    from mipheivit_tpu.train import optim as jo
    from mipheivit_tpu.train import steps as js
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.models.convert import discriminator_state_dict_from_jax
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch
    from mipheivit_tpu_torch.train import losses as pl
    from mipheivit_tpu_torch.train import optim as po
    from mipheivit_tpu_torch.train import steps as ps

    jmodel, model, to_port = family(model_name, fg, dtype="float64")
    v = family_variables(family(model_name, fg)[0])
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    batches = [{k: a.astype(np.float64) for k, a in b.items()} for b in _batches(2)]
    weights = np.random.default_rng(7).uniform(1.0, 2.0, OUT).astype(np.float32)
    decay = model_name == "unet"            # the JAX trainer's vit_lr_decay rule

    # --- JAX (the layer decay over DEPTH layers: over 40, JAX's scanned
    # multipliers do not broadcast against 4 blocks)
    jdisc = JD(ndf=8, n_layers=2) if gan else None
    jgen_opt = jo.build_generator_optimizer(model_name, LR, 40, vit_lr_decay=decay,
                                            num_layers=DEPTH, warmup_iters=2)
    jdisc_opt = jo.build_discriminator_optimizer(LR, 40, warmup_iters=2) if gan else None
    jstate = js.create_train_state(
        jax.random.PRNGKey(0), jmodel, jgen_opt, jdisc, jdisc_opt,
        sample_batch={k: jnp.asarray(a) for k, a in batches[0].items()}, gen_variables=v64,
        freeze_model_name=model_name)
    jloss = jl.weighted_mse_loss(50.0, weights)
    jstep = jax.jit(js.make_train_step(jmodel, jloss, jgen_opt, jdisc, jdisc_opt, js.StepConfig(
        gan_train=gan, foreground_head=fg, freeze_model_name=model_name)))
    noise = []
    if gan:
        shape = jdisc.apply({"params": jstate.disc_params, "spectral": jstate.disc_spectral},
                            jnp.asarray(batches[0]["image"]), jnp.asarray(batches[0]["target"]),
                            train=False).shape
        key = jstate.rng
        for _ in batches:
            key, _, d_key = jax.random.split(key, 3)
            k1, k2 = jax.random.split(d_key)
            noise += [np.asarray(jax.random.uniform(k1, shape)),
                      np.asarray(jax.random.uniform(k2, shape))]
    draws = iter(noise)
    monkeypatch.setattr(ps, "_label_noise", lambda shape, gen: _t(next(draws)))

    # --- the port, from the same weights
    load(model, to_port(v)).double()
    before = {k: t.detach().clone() for k, t in model.state_dict().items()}
    disc = None
    if gan:
        disc = DiscriminatorPatch(3 + OUT, ndf=8, n_layers=2)
        disc.load_state_dict({k: _t(a) for k, a in discriminator_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jstate.disc_params),
             "spectral": jax.tree.map(np.asarray, jstate.disc_spectral)}).items()})
        # the discriminator stays f32: its power iteration is f32 by design
    gen_opt = po.build_generator_optimizer(LR, 40, warmup_iters=2, vit_lr_decay=decay,
                                           num_layers=DEPTH)
    disc_opt = po.build_discriminator_optimizer(LR, 40, warmup_iters=2) if gan else None
    state = ps.create_train_state(model, gen_opt, disc, disc_opt, freeze_model_name=model_name,
                                  device="cpu")
    step = ps.make_train_step(model, pl.weighted_mse_loss(50.0, weights), gen_opt, disc,
                              disc_opt, ps.StepConfig(gan_train=gan, foreground_head=fg))

    keys = ("gen_loss", "gen_loss_sim", "gen_adv_loss", "gen_foreground_loss") + (
        ("disc_adv_loss",) if gan else ())
    jmetrics, metrics = JM.zeros(), PixelMetrics.zeros(device="cpu")
    grads0 = None
    for i, batch in enumerate(batches):
        jstate, jmetrics, jlog = jstep(jstate, {k: jnp.asarray(a) for k, a in batch.items()},
                                       jmetrics)
        state, metrics, log = step(state, batch, metrics)
        for key in keys:
            np.testing.assert_allclose(float(log[key]), float(jlog[key]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{key} at microbatch {i}")
        grads0 = grads0 or {n: g.detach().clone() for n, g in log["grads"].items()}
    assert (float(log["gen_foreground_loss"]) > 0) == fg
    assert state.gen_opt_state.adam_count == 2

    want = to_port({"params": jax.tree.map(np.asarray, jstate.gen_params),
                    "batch_stats": jax.tree.map(np.asarray, jstate.gen_batch_stats)})
    got = model.state_dict()
    lr_step = LR * po.pix2pix_schedule(1.0, 40, 2)(1)
    diff2 = ref2 = 0.0
    for name, p in state.gen_params:
        value, ref, start = p.detach().numpy(), want[name], before[name].numpy()
        g = grads0[name]
        if float(g.norm()) <= GRAD_FLOOR * g.numel() ** 0.5:
            assert np.abs(value - ref).max() <= STEP_SLACK * lr_step, name
            continue
        diff2 += float(((value - ref) ** 2).sum())
        ref2 += float(((ref - start) ** 2).sum())
    assert ref2 > 0 and (diff2 / ref2) ** 0.5 <= UPDATE_NORM_RTOL, (diff2 / ref2) ** 0.5
    for name, value in got.items():
        if "running_" in name:
            np.testing.assert_allclose(value.numpy(), want[name], atol=STAT_ATOL, rtol=STAT_RTOL,
                                       err_msg=name)
