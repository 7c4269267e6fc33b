"""The baseline generators' trainable partition, layer decay, dropout and
training driver against the JAX package's, on the CPU.

The trainable partition against ``partition_params`` for ``unet_lora``,
``unet_frozen``, ``unet`` (on a ViT and on ResNet-50) and ``smp_unet``; the
layer-decay multipliers against JAX's on every tensor; the dropout masks
(the state's generator, the keep rate, eval); ``chip_smoke.py``'s UNETR
preset against ``compose``; and ``train_patchgan`` on the ``unetr`` preset
against the JAX trainer from one checkpoint. f32; the port's attention and
K2 run their plain versions.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.infer.loading as port_loading
import mipheivit_tpu_torch.train.trainer as port_trainer
from mipheivit_tpu_torch.models.convert import unetr_state_dict_from_jax
from mipheivit_tpu_torch.models.layers import Dropout, use_generator
from mipheivit_tpu_torch.models.smp_unet import UnetMultiHeads
from mipheivit_tpu_torch.models.unetr import UnetrViT
from mipheivit_tpu_torch.models.vit import ViTConfig
from mipheivit_tpu_torch.train.schedule import pix2pix_schedule, scaled_lr

import torch_synthetic_run as syn
from torch_family_helpers import (DECODER, DEPTH, DEPTHS, DIMS, OUT, family, family_variables,
                                  vit_cfgs)

torch.set_num_threads(2)

# the trainer's export: test_torch_train.py's budget for parameters after
# Adam updates (see ``_assert_moved_like``); BatchNorm running statistics
# (relative too: the heads' variances are large on these weights)
STEP_SLACK, STEP_CLOSE, MAX_FAR_SHARE = 2.0, 5e-2, 0.02
STAT_ATOL, STAT_RTOL = 1e-5, 1e-5


@pytest.mark.parametrize("model_name", ["unet_lora", "unet_frozen", "unet", "smp_unet",
                                        "unet_resnet50", "unet_lora@ctranspath",
                                        "unet_frozen@ctranspath", "hemit"])
def test_trainable_partition_matches_jax(model_name):
    """``set_trainable`` trains the tensors ``partition_params`` trains:
    every one of the UNETR (on a ViT and on ctranspath's Swin), the SMP
    U-Net and the HEMIT generator, ``unet_lora`` and ``unet_frozen``
    included (the JAX ``UnetrViT`` and ``UnetrSwin`` have no module named
    ``encoder``, which the rule freezes)."""
    from mipheivit_tpu.train.optim import partition_params
    from mipheivit_tpu_torch.train.optim import set_trainable

    jmodel, model, to_port = family(model_name)
    v = family_variables(jmodel)
    name = "unet" if model_name == "unet_resnet50" else model_name.split("@")[0]
    trainable, frozen = partition_params(v["params"], name)
    want_t = {k for k in to_port({"params": trainable}) if "running_" not in k}
    want_f = {k for k in to_port({"params": frozen}) if "running_" not in k} if frozen else set()
    got_t = {n for n, _ in set_trainable(model, name)}
    got_f = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert got_t == want_t and got_f == want_f
    assert not got_f              # the JAX rule freezes nothing in these families


def test_layer_decay_multiplier_matches_jax():
    """Every tensor of a ``unet`` UNETR takes JAX's multiplier over 40
    layers: 0.65^41 for the embeddings and tokens, 0.65^(40 - i) in block i
    (LoRA too), 1 elsewhere."""
    import jax

    from mipheivit_tpu.train.optim import layer_decay_multiplier as jax_mult
    from mipheivit_tpu.train.optim import path_of
    from mipheivit_tpu_torch.train.optim import layer_decay_multiplier

    for model_name in ("unet", "unet_lora"):
        jmodel, model, to_port = family(model_name)
        v = family_variables(jmodel)

        def mult(kp, leaf):
            m = np.asarray(jax_mult(path_of(kp), leaf, 0.65, 40), np.float32)
            if m.ndim:                   # scanned blocks: one multiplier a layer
                m = m[:leaf.shape[0]]
            return np.broadcast_to(m, leaf.shape)

        want = to_port({"params": jax.tree_util.tree_map_with_path(mult, v["params"])})
        seen = set()
        for name, p in model.named_parameters():
            got = layer_decay_multiplier(model, name, 0.65, 40)
            values = np.unique(want[name])
            assert values.size == 1, (name, values)
            assert np.float32(got) == values[0], (name, got, values[0])
            seen.add(got)
        assert len(seen) == DEPTH + 2     # the blocks, the embeddings, the rest


def test_dropout_draws_from_the_state_generator():
    """Dropout keeps 1 - p of the elements, scaled by 1 / (1 - p); a seeded
    generator repeats its masks; eval and p = 0 leave x as it is; training
    without a generator raises (nothing draws from torch's global one)."""
    drop = Dropout(0.1).train()
    x = torch.ones(1_000_000)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(x)
    keep = float((y != 0).float().mean())
    assert abs(keep - 0.9) < 3e-3, keep
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / 0.9, rtol=1e-6)
    assert torch.equal(drop.eval()(x), x)

    _, pcfg = vit_cfgs(8)
    model = UnetrViT(pcfg, out_chans=OUT, drop_rate=0.5)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    outs = []
    for seed in (5, 5, 6):
        use_generator(model, torch.Generator().manual_seed(seed))
        before = {k: t.clone() for k, t in model.state_dict().items()}
        with torch.no_grad():
            outs.append(model.train()(x))
        model.load_state_dict(before)       # the next forward from the same statistics
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    plain = UnetrViT(pcfg, out_chans=OUT)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(model.eval()(x), plain.eval()(x))
    # the SMP decoder drops out after conv1 of blocks 1 and 2 alone, as JAX's
    smp = UnetMultiHeads("tu-convnext_large", DECODER, OUT, dropout=0.1, encoder_dims=DIMS,
                         encoder_depths=DEPTHS)
    assert [b.drop.p for b in smp.decoder.blocks] == [0.0, 0.1, 0.1, 0.0, 0.0]
    assert sum(m.p == 0.5 for m in model.modules() if isinstance(m, Dropout)) == 17


def test_chip_smoke_unetr_preset_is_the_composed_preset():
    """``chip_smoke.py`` trains the UNETR preset (and the hemit and
    ctranspath ones) from a dict (the card has no PyYAML): each equals the
    port's ``compose`` of its preset, which holds the JAX package's tree
    byte for byte."""
    import sys

    from mipheivit_tpu_torch.config import compose

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    assert chip_smoke.UNETR_PRESET == compose(["+default_configs=unetr"]).to_dict()
    assert chip_smoke.UNETR_PRESET["model"]["model_name"] == "unet_lora"
    assert chip_smoke.HEMIT_PRESET == compose(["+default_configs=hemit"]).to_dict()
    assert chip_smoke.CTRANSPATH_PRESET == compose(
        ["+experiments/foundation_models=ctranspath"]).to_dict()


# ---------------------------------------------------------------------------
# train_patchgan on the UNETR preset against the JAX trainer


TINY_UNETR = dict(img_size=(32, 32), patch_size=16, embed_dim=32, depth=DEPTH, num_heads=1,
                  mlp_hidden_dim=64, reg_tokens=4)


def _tiny_unetr(model_name, img_size, nc_out, encoder_name="hoptimus0", dtype=torch.float32,
                device="cpu", dropout=0.0, foreground_head=False):
    """Stands in for the port's ``get_generator``: a tiny ``UnetrViT``."""
    cfg = ViTConfig(**TINY_UNETR, lora_rank=8 if "lora" in model_name else 0)
    with torch.device(device):
        return UnetrViT(cfg, nc_out, drop_rate=dropout).eval()


@pytest.fixture(scope="module")
def unetr_workspace(tmp_path_factory):
    """The synthetic run of ``tests/torch_synthetic_run.py`` and a
    reference-layout UNETR checkpoint of plausible weights."""
    import sys

    from mipheivit_tpu_torch.io.safetensors import save_file

    root = tmp_path_factory.mktemp("trainer_unetr")
    values = syn.write_run(root)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from make_parity_fixtures import synth_state_dict

    model = _tiny_unetr("unet_lora", 32, len(syn.MARKERS))
    state = {k: t.numpy() for k, t in model.state_dict().items()}
    state.update(synth_state_dict([(k, tuple(t.shape)) for k, t in model.state_dict().items()
                                   if t.is_floating_point()]))
    (root / "ckpt").mkdir()
    save_file(state, root / "ckpt" / "model.safetensors")
    values["model.checkpoint_path"] = str(root / "ckpt" / "model.safetensors")
    return root, values


def _unetr_cfg(compose, values):
    # dropout off: its masks are draws of each package's own generator
    return syn.configure(compose(["+default_configs=unetr"]), values, model__dropout=0.0)


def test_train_patchgan_unetr_matches_jax(unetr_workspace, monkeypatch):
    """The ``unetr`` preset (``unet_lora``; the synthetic run's settings, cell
    metrics off) through both trainers from one checkpoint: every line of
    ``metrics.jsonl``, and the export (the port's reference layout, the JAX
    trainer's flattened flax layout) tensor for tensor."""
    import jax

    import mipheivit_tpu.infer.loading as jax_loading
    import mipheivit_tpu.train.trainer as jax_trainer
    from mipheivit_tpu.config import compose as jax_compose
    from mipheivit_tpu.models.unetr import UnetrViT as JU
    from mipheivit_tpu.models.vit import ViTConfig as JC
    from mipheivit_tpu_torch.config import compose
    from mipheivit_tpu_torch.io.safetensors import load_file
    from test_torch_trainer import _assert_lines_match, _lines

    root, values = unetr_workspace
    jcfg = JC(attn_impl="xla", remat=False, lora_rank=8, **TINY_UNETR)
    monkeypatch.setattr(jax_trainer, "get_generator",
                        lambda name, w, ci, co, cfg, dtype="float32": JU(vit_cfg=jcfg,
                                                                          out_chans=co))
    monkeypatch.setattr(jax_loading, "build_generator",
                        lambda cfg, img_size, nc_out, dtype="float32": JU(vit_cfg=jcfg,
                                                                          out_chans=nc_out))
    want_dir = root / "jax"
    jax_trainer.train_patchgan(_unetr_cfg(jax_compose, values), str(want_dir), dtype="float32",
                               use_wandb=False)

    monkeypatch.setattr(port_loading, "get_generator", _tiny_unetr)
    monkeypatch.setattr(port_trainer, "get_generator", _tiny_unetr)
    got_dir = root / "port"
    out = port_trainer.train_patchgan(_unetr_cfg(compose, values), str(got_dir), use_wandb=False,
                                      device="cpu")
    lines = _lines(got_dir)
    _assert_lines_match(lines, _lines(want_dir))
    assert out["state"].step == 4 and (got_dir / "status.txt").read_text() == "finished"

    # the JAX export, unflattened and mapped into the port's names
    flat = load_file(want_dir / "model.safetensors")
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value.numpy()
    want = unetr_state_dict_from_jax(tree, ViTConfig(**TINY_UNETR, lora_rank=8))
    got = load_file(got_dir / "model.safetensors")
    before = load_file(values["model.checkpoint_path"])
    assert set(got) == set(want)
    best_epoch = min(range(2), key=lambda e: lines[e]["val_gen_loss_sim"])
    lr_step = scaled_lr(2e-4, 4) * sum(pix2pix_schedule(1.0, 4)(c)
                                       for c in range(2 * (best_epoch + 1)))
    noise = _biases_before_batchnorm(out["state"].generator)
    assert len(noise) == 19     # 11 conv blocks, 6 deconv blocks, 2 gates
    for name, value in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        if "running_" in name:
            np.testing.assert_allclose(value.numpy(), want[name], atol=STAT_ATOL, rtol=STAT_RTOL,
                                       err_msg=name)
        elif name.startswith("encoder.model.norm."):
            # the ViT's final norm is off the UNETR's path (its taps are
            # un-normed): no gradient and no update in either package
            np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
            np.testing.assert_array_equal(value.numpy(), before[name].numpy(), err_msg=name)
        elif name in noise:
            # zero gradient in exact arithmetic: f32 noise that Adam turns
            # into steps of either sign, the same bound as in the step test
            assert np.abs(value.numpy() - want[name]).max() <= STEP_SLACK * lr_step, name
        else:
            _assert_moved_like(value.numpy(), want[name], before[name].numpy(), lr_step, name)

    # the export loads back through load_generator, and the eval-only driver
    # runs on it
    from mipheivit_tpu_torch.train.test_driver import test_model

    assert isinstance(port_loading.load_generator("unet_lora", "hoptimus0", got_dir, (32, 32),
                                                  len(syn.MARKERS), device="cpu"), UnetrViT)
    assert json.loads((got_dir / "metrics.jsonl").read_text().splitlines()[0])["epoch"] == 0
    res = test_model(_unetr_cfg(compose, values), str(got_dir), "unetr", device="cpu")
    assert set(res) >= {"val_psnr", "test_psnr", "test_gen_loss_sim"}
    assert all(np.isfinite(v) for v in res.values())


def _biases_before_batchnorm(model):
    """The biases of the convolutions that feed a BatchNorm directly: their
    gradient is zero in exact arithmetic in training mode."""
    from torch import nn

    out = set()
    for prefix, seq in model.named_modules():
        if not isinstance(seq, nn.Sequential):
            continue
        mods = list(seq.named_children())
        for (name, conv), (_, bn) in zip(mods, mods[1:]):
            if (isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)) and conv.bias is not None
                    and isinstance(bn, nn.BatchNorm2d)):
                out.add(f"{prefix}.{name}.bias")
    return out


def _assert_moved_like(got, want, before, step, name):
    """``test_torch_train.py``'s budget for parameters after Adam updates of
    about ``step`` an element (each within two steps; at most 2 % more than
    5 % of a step apart), where "apart" also allows 4 f32 ulps of the value:
    the preset's first updates are ~1e-6, below the ulp of a BatchNorm
    scale near 1 (1.2e-7 is 12 % of such a step)."""
    diff = np.abs(got - want)
    close = np.maximum(STEP_CLOSE * step, 4 * np.finfo(np.float32).eps * np.abs(want))
    assert diff.max() <= STEP_SLACK * step, (name, diff.max(), step)
    assert np.mean(diff > close) <= MAX_FAR_SHARE, (name, np.mean(diff > close))
    assert np.abs(want - before).max() > 0, name


# ---------------------------------------------------------------------------
# the HEMIT preset and the ctranspath experiment through the port's trainer


def _tiny_swin_family(model_name, img_size, nc_out, encoder_name="hoptimus0",
                      dtype=torch.float32, device="cpu", dropout=0.0, foreground_head=False):
    """Stands in for the port's ``get_generator``: the tiny generators of
    ``torch_family_helpers.family`` at the synthetic run's 32 px."""
    from mipheivit_tpu_torch.models.hemit import ResnetGeneratorSwinT
    from mipheivit_tpu_torch.models.swin import SwinConfig
    from mipheivit_tpu_torch.models.unetr import UnetrSwin
    from torch_family_helpers import SWIN_TINY

    size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    swin = dict(SWIN_TINY, patch_size=2, img_size=size)
    with torch.device(device):
        if model_name == "hemit":
            return ResnetGeneratorSwinT(nc_out, size, ngf=8, n_blocks=1,
                                        swin_cfg=SwinConfig(**swin)).eval()
        assert encoder_name == "ctranspath"
        return UnetrSwin(SwinConfig(conv_stem=True, lora_rank=8 if "lora" in model_name else 0,
                                    **dict(swin, patch_size=4)),
                         nc_out).eval()


@pytest.mark.parametrize("preset", ["+default_configs=hemit",
                                    "+experiments/foundation_models=ctranspath"])
def test_train_patchgan_and_test_model_run_the_swin_presets(preset, tmp_path, monkeypatch):
    """The ``hemit`` preset (cell metrics, monitor ``val_cell_auc``) and the
    ctranspath experiment file (``unet_lora``: every tensor trains, as in
    JAX) as they ship, on the synthetic run with tiny generators: two epochs
    of ``train_patchgan``, then ``test_model`` on the export, which
    ``load_generator`` refuses for these families (as in JAX) and
    ``load_trainer_export`` loads as the trainer wrote it."""
    import mipheivit_tpu_torch.train.test_driver as port_driver
    from mipheivit_tpu_torch.config import compose

    values = syn.write_run(tmp_path / "run", cells=True)
    cfg = syn.configure(compose([preset]), values, cells="hemit" in preset)
    if "ctranspath" in preset:
        cfg.set_dotted("train.use_cell_metrics", False)
    monkeypatch.setattr(port_trainer, "get_generator", _tiny_swin_family)
    monkeypatch.setattr(port_loading, "get_generator", _tiny_swin_family)
    out = port_trainer.train_patchgan(cfg, str(tmp_path / "logs"), use_wandb=False,
                                      device="cpu")
    state = out["state"]
    assert len(state.gen_params) == sum(1 for _ in state.generator.parameters())
    lines = _lines_of(tmp_path / "logs")
    assert [line["epoch"] for line in lines if "epoch" in line] == [0, 1]
    with pytest.raises(NotImplementedError, match="checkpoint import not implemented"):
        port_loading.load_generator(cfg.model.model_name,
                                    cfg.select("model.encoder.encoder_name"),
                                    tmp_path / "logs", (32, 32), 2, device="cpu")
    res = port_driver.test_model(cfg, str(tmp_path / "logs"), "swin", device="cpu")
    assert np.isfinite(res["test_psnr"]) and np.isfinite(res["val_gen_loss_sim"])
    if "hemit" in preset:
        assert np.isfinite(res["val_cell_auc"])


def _lines_of(logdir):
    return [json.loads(x) for x in (Path(logdir) / "metrics.jsonl").read_text().splitlines()]
