"""The system under test, built from a configuration file: the port's
generator at the configuration's widths, its seeded weights, and the
serving transforms that ``infer.tiles.load_serving_model`` applies after
its file read (fast heads for the flagship, ``merge_lora``,
``cast_params``). No checkpoint is written or read.
"""

from __future__ import annotations

import torch

from . import weights
from .reference import models as ref_models

SERVE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(cfg: dict, img: int, device) -> torch.nn.Module:
    """The port's generator for ``cfg`` at ``img`` px (f32, per-marker heads),
    after holding its encoder's settings and its tensor names and shapes to
    the configuration's."""
    from mipheivit_tpu_torch.models import get_generator

    model = get_generator(cfg["generator"], img, cfg["markers"], cfg["encoder_name"],
                          device=device)
    want = {k: v for k, v in cfg["encoder"].items() if k != "kind"}
    want.update({k: cfg[k] for k in ("lora_rank", "lora_alpha") if k in cfg})
    found = [m.cfg for m in model.modules()
             if all(hasattr(getattr(m, "cfg", None), k) for k in want)]
    if len(found) != 1:
        raise RuntimeError(f"{cfg['name']}: expected one encoder whose settings carry the "
                           f"configuration's {sorted(want)}, found {len(found)}")
    for key, value in want.items():
        if getattr(found[0], key) != value:
            raise RuntimeError(f"{cfg['name']}: the program's encoder has {key}="
                               f"{getattr(found[0], key)!r}, the configuration states {value!r}")
    got = {n: tuple(t.shape) for n, t in model.state_dict().items() if t.is_floating_point()}
    want = ref_models.param_shapes(cfg, img)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise RuntimeError(f"{cfg['name']}: the program's tensors differ from the "
                           f"reference's: {diff}")
    return model


def seeded(model: torch.nn.Module, cfg: dict, seed: int) -> torch.nn.Module:
    return weights.fill(model, seed, dtype=SERVE_DTYPES[cfg["serve_dtype"]])


def serving_model(cfg: dict, img: int, seed: int, device, int8: bool = False):
    """The generator as served: seeded, fast heads (the flagship), LoRA
    merged, cast to the configuration's serving dtype; with ``int8`` the
    program's opt-in W8A8 path on top (``--int8``: ``quantize_encoder`` then
    ``quantize_decoder``)."""
    from mipheivit_tpu_torch.infer import cast_params, merge_lora, to_fast_heads
    from mipheivit_tpu_torch.infer.loading import quantize_decoder, quantize_encoder

    model = seeded(generator(cfg, img, device), cfg, seed)
    if cfg.get("fast_heads"):
        model = to_fast_heads(model)
    model = cast_params(merge_lora(model), SERVE_DTYPES[cfg["serve_dtype"]])
    if int8:
        model = quantize_decoder(quantize_encoder(model))
    return model.eval()


def normalizer(cfg: dict):
    """The program's own H&E normalizer for this generator and encoder."""
    from mipheivit_tpu_torch.data.stats import get_input_mean_std
    from mipheivit_tpu_torch.infer.tiles import HEStats

    ms = get_input_mean_std(cfg["generator"], cfg["encoder_name"], {})
    return HEStats(ms["mean"], ms["std"])
