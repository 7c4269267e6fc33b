"""The PyTorch port's training step against the JAX package, at tiny sizes.

Losses, schedule, pixel metrics, the optimizer chain (clip, Adam, schedule,
accumulation), the discriminator, ``make_train_step`` on the K1 route
(S <= 512) and the K4/K5 route (S > 512) with and without the GAN branch,
and the export of a trained generator into the JAX forward. Inputs come from
numpy seeds; both sides start from the same weights (the JAX variables
mapped by ``models.convert``). Everything runs in f32 on the CPU, where the
port's attention is its plain versions.
"""

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.models.convert import (discriminator_state_dict_from_jax,
                                                state_dict_from_jax)

torch.set_num_threads(2)

OUT = 2
LR = 1e-3
# Losses, metrics and gradients are the same f32 math in another order.
LOSS_RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 2e-6, 2e-4
STAT_ATOL = 1e-5
# Whole-model gradients, in norm: a ReLU input within f32 rounding of 0 can
# take the other branch on one side (measured: 1 of 1M decoder elements on
# these fixtures, against an f64 run of the port), which moves every
# gradient upstream of it by ~2e-3 of its norm. The floor covers gradients
# that are 0 in exact arithmetic (a conv bias ahead of a training BatchNorm).
GRAD_NORM_RTOL, GRAD_NORM_FLOOR = 1e-2, 1e-6
# After an Adam update each element moves by about lr * schedule; a gradient
# within f32 noise of 0 can take the other sign on the other side, so a
# parameter may differ by up to twice that step. Adam's m/sqrt(v) turns the
# gradients' ~2e-3 (above) into larger shares of a step where successive
# gradients nearly cancel, so the bulk check is: at most 2 % of the elements
# differ by more than 5 % of a step.
STEP_SLACK, STEP_CLOSE, MAX_FAR_SHARE = 2.0, 5e-2, 0.02


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


# ---------------------------------------------------------------------------
# losses, schedule, metrics


def test_losses_match_jax():
    import jax.numpy as jnp

    from mipheivit_tpu.train import losses as jl
    from mipheivit_tpu_torch.train import losses as pl

    g = _rng(0)
    y = g.uniform(-0.9, 0.9, (2, 8, 8, 4)).astype(np.float32)
    f = g.uniform(-1.0, 1.0, (2, 8, 8, 4)).astype(np.float32)
    logits = g.standard_normal((2, 5, 5, 1)).astype(np.float32)
    labels = g.uniform(0, 1, (2, 5, 5, 1)).astype(np.float32)
    w = g.uniform(0.5, 3.0, 4).astype(np.float32)
    th = g.uniform(-0.5, 0.5, 4).astype(np.float32)
    pairs = [
        (jl.weighted_mse_loss(50.0, w), pl.weighted_mse_loss(50.0, w)),
        (jl.focal_l1_cubed_loss(50.0, w), pl.focal_l1_cubed_loss(50.0, w)),
        (jl.mae_loss(3.0), pl.mae_loss(3.0)),
        (jl.mse_loss(3.0), pl.mse_loss(3.0)),
        (jl.weighted_mae_loss(2.0, w, th), pl.weighted_mae_loss(2.0, w, th)),
        (jl.shrinkage_loss(5.0, w), pl.shrinkage_loss(5.0, w)),
        (jl.l1_l2_loss(4.0), pl.l1_l2_loss(4.0)),
    ]
    for want_fn, got_fn in pairs:
        np.testing.assert_allclose(float(got_fn(_t(y), _t(f))),
                                   float(want_fn(jnp.asarray(y), jnp.asarray(f))), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pl.total_variation_loss(_t(f))),
                               float(jl.total_variation_loss(jnp.asarray(f))), rtol=LOSS_RTOL)
    for lsgan in (False, True):
        np.testing.assert_allclose(
            float(pl.adversarial_loss(_t(logits), _t(labels), lsgan)),
            float(jl.adversarial_loss(jnp.asarray(logits), jnp.asarray(labels), lsgan)),
            rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pl.focal_bce_loss(0.75, 2.0)(_t(logits), _t(labels))),
                               float(jl.focal_bce_loss(0.75, 2.0)(jnp.asarray(logits),
                                                                  jnp.asarray(labels))),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(pl.marker_weights_from_stds([0.5, 0.25, 1.0]),
                                  jl.marker_weights_from_stds([0.5, 0.25, 1.0]))


def test_build_reconstruction_loss_matches_jax(tmp_path):
    import json

    import jax.numpy as jnp
    import pandas as pd

    from mipheivit_tpu.config import Config
    from mipheivit_tpu.data.stats import load_channel_stats as jax_stats
    from mipheivit_tpu.train.losses import build_reconstruction_loss as jax_build
    from mipheivit_tpu_torch.data.stats import load_channel_stats
    from mipheivit_tpu_torch.train.losses import build_reconstruction_loss

    path = tmp_path / "stats.json"
    path.write_text(json.dumps({"RGB": {"mean": [1, 2, 3], "std": [1, 1, 1]},
                                "A": {"idx_channel": 0, "std": 0.5},
                                "B": {"idx_channel": 1, "std": 0.2}}))
    df = pd.DataFrame({"A_prop": [0.1, 0.3], "B_prop": [0.5, 0.7]})
    g = _rng(1)
    y, f = (g.uniform(-0.9, 0.9, (2, 4, 4, 2)).astype(np.float32) for _ in range(2))
    for mae in (False, True):
        cfg = Config.create({"train": {"losses": {"lambda_factor": 50.0, "use_weighted_mae": mae}}})
        want = jax_build(cfg, ["A", "B"], jax_stats(str(path)), df)
        got = build_reconstruction_loss(cfg, ["A", "B"], load_channel_stats(str(path)), df)
        np.testing.assert_allclose(float(got(_t(y), _t(f))),
                                   float(want(jnp.asarray(y), jnp.asarray(f))), rtol=LOSS_RTOL)


def test_schedule_matches_jax():
    from mipheivit_tpu.train import schedule as js
    from mipheivit_tpu_torch.train import schedule as ps

    want, got = js.pix2pix_schedule(2.0, 100, 10), ps.pix2pix_schedule(2.0, 100, 10)
    for step in (0, 1, 5, 9, 10, 30, 49, 50, 51, 75, 99, 100, 120):
        assert got(step) == float(want(step)), step
    assert ps.scaled_lr(2e-4, 16) == js.scaled_lr(2e-4, 16)
    for name in ("encoder/vit/pos_embed", "encoder/vit/blocks_3/attn", "decoder/conv"):
        assert ps.vit_layer_decay_rate(name, 0.65, 12) == js.vit_layer_decay_rate(name, 0.65, 12)
    assert ps.vit_layer_decay_rate("encoder.vit.blocks.3.attn", 0.65, 12) == \
        js.vit_layer_decay_rate("encoder/vit/blocks_3/attn", 0.65, 12)


def test_pixel_metrics_match_jax():
    import jax.numpy as jnp

    from mipheivit_tpu.metrics import pixel as jp
    from mipheivit_tpu_torch.metrics import pixel as pp

    g = _rng(2)
    batches = [(g.uniform(-1, 1, (3, 24, 20, 2)).astype(np.float32),
                g.uniform(-0.9, 0.9, (3, 24, 20, 2)).astype(np.float32)) for _ in range(2)]
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    want, got = jp.PixelMetrics.zeros(), pp.PixelMetrics.zeros()
    for i, (p, t) in enumerate(batches):
        m = mask if i else None
        want = want.update(jnp.asarray(p), jnp.asarray(t), mask=None if m is None else jnp.asarray(m))
        got = got.update(_t(p), _t(t), mask=None if m is None else _t(m))
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(float(got.compute()[key]), float(want.compute()[key]),
                                   rtol=1e-5)
    p, t = batches[0]
    np.testing.assert_allclose(pp.ssim_per_image(_t(p), _t(t)).numpy(),
                               np.asarray(jp.ssim_per_image(jnp.asarray(p), jnp.asarray(t))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pp.psnr(_t(p), _t(t))),
                               float(jp.psnr(jnp.asarray(p), jnp.asarray(t))), rtol=1e-5)


# ---------------------------------------------------------------------------
# the optimizer chain


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_adam_chain_with_clip_and_accumulation_matches_optax(which):
    """Six microbatches, accumulation 2: three emitted updates, the first of
    them zero (schedule factor 0 at step 0); grads both below and above the
    clip norm."""
    import jax
    import jax.numpy as jnp
    import optax

    from mipheivit_tpu.train import optim as jo
    from mipheivit_tpu_torch.train import optim as po

    g = _rng(3)
    tree = {"encoder": {"vit": {"blocks": {"attn": {"lora_q": {
        "B": g.standard_normal((2, 4, 6)).astype(np.float32)}}}}},
        "decoder": {"w": g.standard_normal((5, 3)).astype(np.float32),
                    "b": g.standard_normal(3).astype(np.float32)}}
    leaves, treedef = jax.tree.flatten(tree)
    if which == "generator":
        jopt = jo.build_generator_optimizer("myvitmatte", LR, 40, warmup_iters=2,
                                            grad_accum_steps=2)
        popt = po.build_generator_optimizer(LR, 40, warmup_iters=2, grad_accum_steps=2)
    else:
        jopt = jo.build_discriminator_optimizer(LR, 40, warmup_iters=2, grad_accum_steps=2)
        popt = po.build_discriminator_optimizer(LR, 40, warmup_iters=2, grad_accum_steps=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    pparams = [_t(x) for x in leaves]
    pstate = popt.init(pparams)
    for i, scale in enumerate((0.01, 3.0, 0.02, 0.05, 5.0, 0.5)):
        grads = [g.standard_normal(x.shape).astype(np.float32) * scale for x in leaves]
        updates, jstate = jopt.update(jax.tree.unflatten(treedef, [jnp.asarray(x) for x in grads]),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        emitted = popt.step(pparams, [_t(x) for x in grads], pstate)
        assert emitted == (i % 2 == 1)
        for got, want in zip(pparams, jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    assert pstate.adam_count == 3 and pstate.schedule_count == 3


# ---------------------------------------------------------------------------
# the discriminator


def test_discriminator_matches_jax():
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models.discriminator import DiscriminatorPatch as JD
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch

    g = _rng(4)
    x = g.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = g.uniform(-0.9, 0.9, (2, 64, 64, OUT)).astype(np.float32)
    jd = JD(ndf=8, n_layers=2)
    variables = jd.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(y), train=False)
    pd = DiscriminatorPatch(3 + OUT, ndf=8, n_layers=2)
    pd.load_state_dict({k: _t(v) for k, v in discriminator_state_dict_from_jax(
        jax.tree.map(np.asarray, variables)).items()})

    # train=False: u read, not stored; gradients through the weights
    def jloss(params):
        return jnp.mean(jd.apply({"params": params, "spectral": variables["spectral"]},
                                 jnp.asarray(x), jnp.asarray(y), train=False) ** 2)

    want_loss, want_grads = jax.value_and_grad(jloss)(variables["params"])
    loss = torch.mean(pd(_t(x), _t(y), update_stats=False) ** 2)
    grads = torch.autograd.grad(loss, list(pd.parameters()))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    want_sd = discriminator_state_dict_from_jax({"params": jax.tree.map(np.asarray, want_grads),
                                                 "spectral": variables["spectral"]})
    for (name, _), grad in zip(pd.named_parameters(), grads):
        np.testing.assert_allclose(grad.numpy(), want_sd[name], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    # train=True twice: one power iteration each, u stored
    out, mut = jd.apply(variables, jnp.asarray(x), jnp.asarray(y), train=True,
                        mutable=["spectral"])
    out, mut = jd.apply({"params": variables["params"], **mut}, jnp.asarray(x), jnp.asarray(y),
                        train=True, mutable=["spectral"])
    pd(_t(x), _t(y), update_stats=True)
    got = pd(_t(x), _t(y), update_stats=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-4, atol=1e-6)
    want_u = discriminator_state_dict_from_jax({"params": variables["params"], **mut})
    for name, buf in pd.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_u[name], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# make_train_step against the JAX step


def _configs(route):
    """(JAX ViTConfig, port ViTConfig): width 128, 2 heads of 64, depth 2,
    LoRA rank 8 at 128 px. Patch 16 gives 64 + 5 tokens (K1's route),
    patch 4 gives 1024 + 5 (K4/K5's)."""
    from mipheivit_tpu.models import ViTConfig as JC
    from mipheivit_tpu_torch.models.vit import ViTConfig as PC

    kw = dict(img_size=(128, 128), patch_size=16 if route == "k1" else 4, embed_dim=128,
              depth=2, num_heads=2, mlp_hidden_dim=256, reg_tokens=4, no_embed_class=True,
              lora_rank=8)
    return JC(remat=False, **kw), PC(**kw)


def _jax_variables(model, x):
    """Initialised JAX variables with LoRA B non-zero and LayerScale at a
    trained magnitude, so the adapters see real gradients."""
    import jax

    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(0)))
    g = _rng(5)
    blocks = variables["params"]["encoder"]["vit"]["blocks"]
    for lq in ("lora_q", "lora_v"):
        b = blocks["attn"][lq]["B"]
        blocks["attn"][lq]["B"] = (g.standard_normal(b.shape) * 0.05).astype(np.float32)
    for ls in ("ls1", "ls2"):
        blocks[ls] = g.uniform(0.05, 0.15, blocks[ls].shape).astype(np.float32)
    return variables


def _port_generator(pcfg, variables):
    from mipheivit_tpu_torch.models.mipheivit import MipheiViT

    model = MipheiViT(pcfg, out_chans=OUT)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(variables, pcfg, OUT).items()})
    return model


def _batches(n, b=2):
    g = _rng(6)
    return [{"image": g.standard_normal((b, 128, 128, 3)).astype(np.float32),
             "target": g.uniform(-0.9, 0.9, (b, 128, 128, OUT)).astype(np.float32)}
            for _ in range(n)]


def _assert_moved_like(got, want, before, step, name):
    """Parameters after an Adam update, with the lr-scaled budget above."""
    diff = np.abs(got - want)
    assert diff.max() <= STEP_SLACK * step, (name, diff.max(), step)
    assert np.mean(diff > STEP_CLOSE * step) <= MAX_FAR_SHARE, (name, np.mean(diff > STEP_CLOSE * step))
    assert np.abs(want - before).max() > 0, name


@pytest.mark.parametrize("route,gan", [("k1", False), ("k1", True), ("k4", False), ("k4", True)])
def test_train_step_matches_jax(route, gan, monkeypatch):
    """Four microbatches with accumulation 2 (two optimizer steps, the first
    a zero update): losses, the first microbatch's trainable gradients,
    BatchNorm running statistics, the discriminator's power-iteration state,
    and every parameter after the second update; frozen weights stay
    bit-identical."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.metrics import PixelMetrics as JM
    from mipheivit_tpu.models import MipheiViT as JG
    from mipheivit_tpu.models.discriminator import DiscriminatorPatch as JD
    from mipheivit_tpu.train import losses as jl
    from mipheivit_tpu.train import optim as jo
    from mipheivit_tpu.train import steps as js
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch
    from mipheivit_tpu_torch.ops import attention as port_attention
    from mipheivit_tpu_torch.train import losses as pl
    from mipheivit_tpu_torch.train import optim as po
    from mipheivit_tpu_torch.train import steps as ps

    jcfg, pcfg = _configs(route)
    batches = _batches(4)
    weights = _rng(7).uniform(1.0, 2.0, OUT).astype(np.float32)

    # --- JAX
    jmodel = JG(vit_cfg=jcfg, out_chans=OUT)
    x0 = jnp.asarray(batches[0]["image"])
    variables = _jax_variables(jmodel, x0)
    jdisc = JD(ndf=8, n_layers=2) if gan else None
    jgen_opt = jo.build_generator_optimizer("myvitmatte", LR, 40, warmup_iters=2,
                                            grad_accum_steps=2)
    jdisc_opt = jo.build_discriminator_optimizer(LR, 40, warmup_iters=2,
                                                 grad_accum_steps=2) if gan else None
    jstate = js.create_train_state(
        jax.random.PRNGKey(0), jmodel, jgen_opt, jdisc, jdisc_opt,
        sample_batch={k: jnp.asarray(v) for k, v in batches[0].items()},
        gen_variables=variables, freeze_model_name="myvitmatte")
    jloss_fn = jl.weighted_mse_loss(50.0, weights)
    jstep = jax.jit(js.make_train_step(jmodel, jloss_fn, jgen_opt, jdisc, jdisc_opt,
                                       js.StepConfig(gan_train=gan,
                                                     freeze_model_name="myvitmatte")))
    # the first microbatch's trainable gradients, as the JAX step takes them
    trainable, frozen = jo.partition_params(jstate.gen_params, "myvitmatte")

    def gen_loss(tp):
        out, _ = jmodel.apply({"params": jo.combine_params(tp, frozen),
                               "batch_stats": jstate.gen_batch_stats}, x0, train=True,
                              mutable=["batch_stats"])
        loss = jloss_fn(jnp.asarray(batches[0]["target"]), out)
        if gan:
            logits = jdisc.apply({"params": jstate.disc_params, "spectral": jstate.disc_spectral},
                                 x0, out, train=False)
            loss = loss + jl.adversarial_loss(logits, jnp.zeros_like(logits))
        return loss

    _, jgrads = jax.jit(jax.value_and_grad(gen_loss))(trainable)
    want_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)}, pcfg, OUT)

    # the JAX step's label-noise draws, handed to the port in the same order
    noise = []
    if gan:
        shape = jdisc.apply({"params": jstate.disc_params, "spectral": jstate.disc_spectral},
                            x0, jnp.asarray(batches[0]["target"]), train=False).shape
        key = jstate.rng
        for _ in batches:
            key, _, d_key = jax.random.split(key, 3)
            k1, k2 = jax.random.split(d_key)
            noise += [np.asarray(jax.random.uniform(k1, shape)),
                      np.asarray(jax.random.uniform(k2, shape))]
    draws = iter(noise)
    monkeypatch.setattr(ps, "_label_noise", lambda shape, gen: _t(next(draws)))

    # --- the port, from the same weights
    model = _port_generator(pcfg, variables)
    disc = None
    if gan:
        disc = DiscriminatorPatch(3 + OUT, ndf=8, n_layers=2)
        disc.load_state_dict({k: _t(v) for k, v in discriminator_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jstate.disc_params),
             "spectral": jax.tree.map(np.asarray, jstate.disc_spectral)}).items()})
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen_opt = po.build_generator_optimizer(LR, 40, warmup_iters=2, grad_accum_steps=2)
    disc_opt = po.build_discriminator_optimizer(LR, 40, warmup_iters=2,
                                                grad_accum_steps=2) if gan else None
    state = ps.create_train_state(model, gen_opt, disc, disc_opt, freeze_model_name="myvitmatte",
                                  device="cpu")
    step = ps.make_train_step(model, pl.weighted_mse_loss(50.0, weights), gen_opt, disc,
                              disc_opt, ps.StepConfig(gan_train=gan))
    assert {n for n, _ in state.gen_params} == set(want_grads)

    port_attention.launch_counts.update(attention=0, flash=0, flash_bwd=0, short=0)
    jmetrics, metrics = JM.zeros(), PixelMetrics.zeros()
    for i, batch in enumerate(batches):
        jstate, jmetrics, jlog = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jmetrics)
        state, metrics, log = step(state, batch, metrics)
        for key in ("gen_loss", "gen_loss_sim", "gen_adv_loss") + (("disc_adv_loss",) if gan else ()):
            np.testing.assert_allclose(float(log[key]), float(jlog[key]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{key} at microbatch {i}")
        assert not bool(log["nan"])
        if i == 0:
            for name, grad in log["grads"].items():
                err = np.linalg.norm(grad.numpy() - want_grads[name])
                bound = GRAD_NORM_RTOL * np.linalg.norm(want_grads[name]) + \
                    GRAD_NORM_FLOOR * np.sqrt(grad.numel())
                assert err <= bound, (name, err, bound)
    assert port_attention.launch_counts == {"attention": 0, "flash": 0, "flash_bwd": 0,
                                            "short": 0}
    assert state.step == 4 and state.gen_opt_state.adam_count == 2

    got = model.state_dict()
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.gen_params),
                                "batch_stats": jax.tree.map(np.asarray, jstate.gen_batch_stats)},
                               pcfg, OUT)
    lr_step = LR * po.pix2pix_schedule(1.0, 40, 2)(1)
    trainable_names = {n for n, _ in state.gen_params}
    for name, value in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        if "running_" in name:
            np.testing.assert_allclose(value.numpy(), want[name], atol=STAT_ATOL, err_msg=name)
        elif name in trainable_names:
            _assert_moved_like(value.numpy(), want[name], before[name].numpy(), lr_step, name)
        else:   # frozen: bit-identical, and the JAX step left it alone too
            assert torch.equal(value, before[name]), name
            np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
    if gan:
        want_d = discriminator_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jstate.disc_params),
             "spectral": jax.tree.map(np.asarray, jstate.disc_spectral)})
        for name, value in disc.state_dict().items():
            if name.endswith(".u"):
                np.testing.assert_allclose(value.numpy(), want_d[name], rtol=1e-4, atol=1e-6,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(value.detach().numpy(), want_d[name],
                                           atol=STEP_SLACK * lr_step, err_msg=name)
    for key in ("psnr", "ssim"):      # SSIM of random predictions is ~0: an absolute floor
        np.testing.assert_allclose(float(metrics.compute()[key]),
                                   float(jmetrics.compute()[key]), rtol=1e-5, atol=1e-7)


def test_grad_checkpointing_recomputes_blocks_with_the_same_gradients():
    """``grad_checkpointing`` runs each encoder block's forward again in the
    backward and changes no number."""
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.models.mipheivit import MipheiViT
    from mipheivit_tpu_torch.train import losses, optim, steps

    _, pcfg = _configs("k1")
    batch = _batches(1)[0]
    runs = {}
    for ckpt in (False, True):
        torch.manual_seed(0)
        model = MipheiViT(pcfg, out_chans=OUT)
        calls, block = [], model.encoder.vit.blocks[0]
        block.forward = lambda x, _fwd=block.forward: (calls.append(1), _fwd(x))[1]
        opt = optim.build_generator_optimizer(LR, 40)
        state = steps.create_train_state(model, opt, freeze_model_name="myvitmatte",
                                         device="cpu", grad_checkpointing=ckpt)
        _, _, log = steps.make_train_step(model, losses.mse_loss(1.0), opt)(
            state, batch, PixelMetrics.zeros())
        runs[ckpt] = (len(calls), float(log["gen_loss"]), log["grads"])
    assert runs[False][0] == 1 and runs[True][0] == 2
    assert runs[True][1] == runs[False][1]
    for name, grad in runs[False][2].items():
        torch.testing.assert_close(runs[True][2][name], grad, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# export


def test_export_round_trip_into_jax_forward(tmp_path, monkeypatch):
    """A port-trained generator goes out through safetensors in the
    reference layout with the encoder stripped (LoRA + decoder ship, the
    encoder in its own timm-layout file), loads into the JAX package's
    ``load_generator`` and into the port's, and both forwards match the
    port's own."""
    import jax.numpy as jnp

    import mipheivit_tpu.infer.loading as jax_loading
    import mipheivit_tpu_torch.infer.loading as port_loading
    from mipheivit_tpu.config import compose
    from mipheivit_tpu.models import MipheiViT as JG
    from mipheivit_tpu_torch.io.safetensors import save_file
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.models.mipheivit import MipheiViT
    from mipheivit_tpu_torch.train import checkpoints, losses, optim, steps

    jcfg, pcfg = _configs("k1")
    torch.manual_seed(0)
    model = MipheiViT(pcfg, out_chans=OUT)
    opt = optim.build_generator_optimizer(1e-2, 40, warmup_iters=1)
    state = steps.create_train_state(model, opt, freeze_model_name="myvitmatte", device="cpu")
    step = steps.make_train_step(model, losses.mse_loss(1.0), opt)
    metrics = PixelMetrics.zeros()
    for batch in _batches(2):
        state, metrics, _ = step(state, batch, metrics)
    assert any(p.abs().max() > 0 for n, p in state.gen_params if ".lora_q.B" in n)
    model.eval()
    x = _batches(1, b=1)[0]["image"]
    with torch.no_grad():
        want = model(_t(x)).numpy()

    sd = checkpoints.generator_state_dict(model, strip_foundation=True)
    assert not any(k.startswith("encoder.vit.") and ".lora_" not in k for k in sd)
    assert any(".lora_q." in k for k in sd) and any(k.startswith("decoder.") for k in sd)
    checkpoints.save_generator(model, tmp_path / "model.safetensors", strip_foundation=True)
    enc = {k[len("encoder.vit."):].replace("attn.qkv.qkv.", "attn.qkv."): v
           for k, v in checkpoints.generator_state_dict(model).items()
           if k.startswith("encoder.vit.") and ".lora_" not in k}
    save_file(enc, tmp_path / "encoder.safetensors")
    enc_path = str(tmp_path / "encoder.safetensors")

    jmodel = JG(vit_cfg=jcfg, out_chans=OUT)
    monkeypatch.setattr(jax_loading, "build_generator",
                        lambda c, img_size, nc_out, dtype="float32": jmodel)
    jm, jv = jax_loading.load_generator(compose(["+default_configs=miphei-vit"]), str(tmp_path),
                                        (128, 128), OUT, encoder_ckpt_path=enc_path,
                                        fast_heads=False)
    got = jm.apply(jv, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5, rtol=1e-4)

    # the eval and predict steps on the exported weights
    from mipheivit_tpu.metrics import PixelMetrics as JM
    from mipheivit_tpu.train import losses as jl
    from mipheivit_tpu.train import steps as js

    jstate = js.TrainState(step=jnp.zeros((), jnp.int32), gen_params=jv["params"],
                           gen_batch_stats=jv["batch_stats"], gen_opt_state=None)
    batch = _batches(1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics, jlog = js.make_eval_step(jm, jl.mse_loss(1.0))(jstate, jbatch, JM.zeros())
    emetrics, elog = steps.make_eval_step(model, losses.mse_loss(1.0))(
        state, batch, PixelMetrics.zeros())
    np.testing.assert_allclose(float(elog["gen_loss_sim"]), float(jlog["gen_loss_sim"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(elog["pred"].numpy(), np.asarray(jlog["pred"]), atol=2e-5,
                               rtol=1e-4)
    for key in ("psnr", "ssim"):      # SSIM of random predictions is ~0: an absolute floor
        np.testing.assert_allclose(float(emetrics.compute()[key]),
                                   float(jmetrics.compute()[key]), rtol=1e-5, atol=1e-7)
    pred = steps.make_predict_step(model)(state, batch)
    np.testing.assert_allclose(pred.numpy(), np.asarray(js.make_predict_step(jm)(jstate, jbatch)),
                               atol=2e-5, rtol=1e-4)

    monkeypatch.setattr(port_loading, "get_generator",
                        lambda *a, **kw: MipheiViT(pcfg, out_chans=OUT).eval())
    loaded = port_loading.load_generator("myvitmatte", "hoptimus0", tmp_path, (128, 128), OUT,
                                         device="cpu", encoder_ckpt_path=enc_path,
                                         fast_heads=False)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(_t(x)).numpy(), want, atol=1e-6, rtol=1e-5)
