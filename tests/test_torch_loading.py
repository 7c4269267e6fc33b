"""Checkpoint loading in the port against the JAX package: the exporter's
layout, the stdlib safetensors reader, ``validate_load`` and
``load_generator`` on full and foundation-stripped checkpoint dirs."""

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.infer.loading as port_loading
from mipheivit_tpu_torch.io.safetensors import load_file, save_file
from mipheivit_tpu_torch.models import MipheiViT, ViTConfig
from mipheivit_tpu_torch.models.convert import (generator_state_dict,
                                                 state_dict_from_jax, validate_load)

torch.set_num_threads(2)

GEOM = dict(img_size=(32, 32), patch_size=4, embed_dim=128, depth=2, num_heads=2,
            mlp_hidden_dim=256, reg_tokens=4)
NC = 3


@pytest.fixture(scope="module")
def jax_generator():
    """A tiny JAX MipheiViT with LoRA rank 8: non-zero B, non-trivial BN
    statistics and layerscale; its config, model and numpy variables."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models import MipheiViT as JaxMipheiViT
    from mipheivit_tpu.models import ViTConfig as JaxViTConfig

    cfg = JaxViTConfig(**GEOM, lora_rank=8, attn_impl="flash_interpret", remat=False)
    model = JaxMipheiViT(vit_cfg=cfg, out_chans=NC)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    blocks = variables["params"]["encoder"]["vit"]["blocks"]
    for name in ("ls1", "ls2"):
        blocks[name] = rng.uniform(0.05, 0.15, blocks[name].shape).astype(np.float32)
    for lq in ("lora_q", "lora_v"):
        b = blocks["attn"][lq]["B"]
        blocks["attn"][lq]["B"] = (rng.standard_normal(b.shape) * 0.05).astype(np.float32)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.min() == 1
                   else rng.standard_normal(v.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    return cfg, model, variables


def _tiny_port(model_name, img_size, nc_out, encoder_name="hoptimus0",
               dtype=torch.float32, device="cpu"):
    with torch.device(device):
        return MipheiViT(ViTConfig(**GEOM, lora_rank=8), nc_out).to(dtype).eval()


def _jax_cfg():
    from mipheivit_tpu.config import compose

    return compose(["+default_configs=miphei-vit"])


@pytest.mark.parametrize("stripped", [False, True], ids=["full", "stripped"])
def test_load_generator_matches_jax(jax_generator, tmp_path, monkeypatch, stripped):
    import jax
    import jax.numpy as jnp

    import mipheivit_tpu.infer.loading as jax_loading
    from mipheivit_tpu.train.checkpoints import (mipheivit_state_dict,
                                                 save_safetensors, vit_state_dict)

    cfg, jmodel, variables = jax_generator
    params, stats = variables["params"], variables["batch_stats"]
    save_safetensors(mipheivit_state_dict(params, stats, cfg, NC,
                                          strip_foundation=stripped),
                     str(tmp_path / "model.safetensors"))
    enc_path = None
    if stripped:
        enc_path = str(tmp_path / "encoder.safetensors")
        save_safetensors(vit_state_dict(params["encoder"]["vit"],
                                        cfg.replace(lora_rank=0), ""), enc_path)

    monkeypatch.setattr(jax_loading, "build_generator",
                        lambda c, img_size, nc_out, dtype="float32": jmodel)
    jm, jv = jax_loading.load_generator(_jax_cfg(), str(tmp_path), (32, 32), NC,
                                        encoder_ckpt_path=enc_path, fast_heads=True)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, train=False))(
        jv, jnp.asarray(x)))

    monkeypatch.setattr(port_loading, "get_generator", _tiny_port)
    model = port_loading.load_generator("myvitmatte", "hoptimus0", tmp_path, (32, 32),
                                        NC, device="cpu", encoder_ckpt_path=enc_path,
                                        fast_heads=True)
    assert model.decoder.fast_heads
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
        merged = port_loading.merge_lora(model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(merged, want, atol=2e-5, rtol=1e-4)


def test_load_generator_fills_missing_adapters_as_jax(jax_generator, tmp_path, monkeypatch):
    """A checkpoint without LoRA keys gets A from default_rng(block), B = 0."""
    from mipheivit_tpu.models.import_weights import mipheivit_from_torch
    from mipheivit_tpu.train.checkpoints import mipheivit_state_dict

    cfg, _, variables = jax_generator
    sd = mipheivit_state_dict(variables["params"], variables["batch_stats"], cfg, NC)
    sd = {k: v for k, v in sd.items() if ".lora_" not in k}
    torch.save({"state_dict": {f"generator.{k}": torch.from_numpy(np.array(v))
                               for k, v in sd.items()}},
               tmp_path / "model.weights.ckpt")
    jparams, _ = mipheivit_from_torch(sd, cfg, out_chans=NC)
    monkeypatch.setattr(port_loading, "get_generator", _tiny_port)
    model = port_loading.load_generator("myvitmatte", "hoptimus0", tmp_path, (32, 32), NC,
                                        device="cpu")
    for i in range(cfg.depth):
        wrap = model.encoder.vit.blocks[i].attn.qkv
        for lq in ("lora_q", "lora_v"):
            want = jparams["encoder"]["vit"]["blocks"]["attn"][lq]
            np.testing.assert_array_equal(getattr(wrap, lq).A.detach().numpy(), want["A"][i])
            np.testing.assert_array_equal(getattr(wrap, lq).B.detach().numpy(), want["B"][i])


@pytest.mark.parametrize("layout", ["scanned", "unrolled", "fast_heads"])
def test_state_dict_from_jax_equals_exporter(jax_generator, layout):
    import jax

    from mipheivit_tpu.infer.loading import to_fast_heads
    from mipheivit_tpu.train.checkpoints import mipheivit_state_dict

    cfg, jmodel, variables = jax_generator
    want = mipheivit_state_dict(variables["params"], variables["batch_stats"], cfg, NC)
    if layout == "unrolled":
        vit = dict(variables["params"]["encoder"]["vit"])
        blocks = vit.pop("blocks")
        for i in range(cfg.depth):
            vit[f"blocks_{i}"] = jax.tree.map(lambda a, i=i: a[i], blocks)
        variables = {**variables, "params": {**variables["params"],
                                             "encoder": {"vit": vit}}}
    elif layout == "fast_heads":
        _, variables = to_fast_heads(jmodel, variables)
    got = state_dict_from_jax(variables, cfg, NC)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_safetensors_reader_is_bit_exact(tmp_path):
    from safetensors.numpy import save_file as st_save
    from safetensors.torch import load_file as st_load_torch
    from safetensors.torch import save_file as st_save_torch

    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i64": np.asarray(42, np.int64),
        "u8": rng.integers(0, 255, (2, 2, 3), dtype=np.uint8),
        "f64": rng.standard_normal((1, 3)),
    }
    st_save(arrays, str(tmp_path / "a.safetensors"))
    got = load_file(tmp_path / "a.safetensors")
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].numpy().tobytes() == v.tobytes(), k

    bf16 = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).bfloat16()
    st_save_torch({"bf16": bf16}, str(tmp_path / "b.safetensors"))
    back = load_file(tmp_path / "b.safetensors")["bf16"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), bf16.view(torch.int16))

    # and the writer produces what the reference library reads
    save_file({**arrays, "bf16": bf16}, tmp_path / "c.safetensors")
    ref = st_load_torch(str(tmp_path / "c.safetensors"))
    for k, v in arrays.items():
        assert ref[k].numpy().tobytes() == v.tobytes(), k
    assert torch.equal(ref["bf16"].view(torch.int16), bf16.view(torch.int16))


def test_validate_load_rules():
    validate_load(["encoder.vit.blocks.0.norm1.weight"], [])
    with pytest.raises(ValueError, match="Unexpected"):
        validate_load([], ["decoder.extra.weight"])
    with pytest.raises(ValueError, match="LoRA"):
        validate_load(["encoder.vit.blocks.0.attn.qkv.lora_q.A"], [])
    with pytest.raises(ValueError, match="Missing key"):
        validate_load(["decoder.fusion_blks.0.conv.conv.weight"], [])


def test_generator_state_dict_strips_prefixes():
    state = {"generator._orig_mod.decoder.w": 1, "discriminator.w": 2}
    assert generator_state_dict(state) == {"decoder.w": 1}
    assert generator_state_dict({"_orig_mod.a": 3}) == {"a": 3}
