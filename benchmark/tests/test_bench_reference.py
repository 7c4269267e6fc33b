"""The frozen reference against the port at a tiny size on the CPU, in f32:
the generators' forwards (the flagship's fast heads and merged LoRA, the
UNETR), the training step's losses, gradients and change; and a
generator composed from a new decoder piece, a file alone."""

import json

import numpy as np
import pytest
import torch

from benchmark import compare, inputs, program
from benchmark.drivers import train as train_driver
from benchmark.reference import models as ref
from benchmark.reference import serving
from benchmark.reference import train as ref_train
from benchmark.tests import tiny


@pytest.fixture()
def base(tmp_path, monkeypatch):
    b = tiny.make(tmp_path)
    tiny.patch_specs(monkeypatch, b)
    return b


def _cfg(base, name, dtype="float32"):
    cfg = json.loads((base / "configs" / f"{name}.json").read_text())
    cfg["serve_dtype"] = dtype
    return cfg


@pytest.mark.parametrize("name", ["mipheivit-hoptimus0", "unetr-uni2h"])
def test_forward_matches_the_port(base, name):
    cfg = _cfg(base, name)
    img = 128
    model = program.serving_model(cfg, img, 5, "cpu")
    x = inputs.he_images(2, img, 5, "cpu")
    xn = serving.normalize(x, cfg["he_mean"], cfg["he_std"])
    with torch.no_grad():
        got = model(xn)
        scfg, p = ref.merged(cfg, ref.seeded_params(cfg, img, 5, "cpu"))
        want = ref.forward(scfg, p, xn)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


def test_control_precision_is_further_off(base):
    cfg = _cfg(base, "unetr-uni2h")
    x = serving.normalize(inputs.he_images(2, 128, 5, "cpu"), cfg["he_mean"], cfg["he_std"])
    scfg, p = ref.merged(cfg, ref.seeded_params(cfg, 128, 5, "cpu"))
    with torch.no_grad():
        f32, q = ref.forward(scfg, p, x), ref.forward(scfg, p, x, quant="fp8")
    assert 0 < float((q - f32).abs().max())


def test_training_step_matches_the_port(base):
    cell = tiny.cell(base, "hopt0-train1024")
    cfg = dict(cell.config, serve_dtype="float32")
    tr = dict(cell.traffic, frozen_dtype="float32")
    pool = train_driver.batches(cfg, tr, 3, "cpu")
    model, state, step = train_driver.program_state(cfg, tr, 3, "cpu")
    from mipheivit_tpu_torch.metrics import PixelMetrics

    metrics = PixelMetrics.zeros("cpu")
    start = {n: p.detach().clone() for n, p in state.gen_params}
    names = [n for n, _ in state.gen_params]
    losses, first = [], None
    for s in range(tr["checked_steps"]):
        for a in range(tr["accum"]):
            b = {k: torch.from_numpy(v) for k, v in pool[s * tr["accum"] + a].items()}
            state, metrics, log = step(state, b, metrics)
            losses.append(float(log["gen_loss"]))
        if s == 0:
            first = {n: m / (1 - tr["b1"]) for n, m in zip(names, state.gen_opt_state.mu)}
    got = {"losses": losses, "first_grad": first,
           "change": {n: p.detach() - start[n] for n, p in state.gen_params}}
    data = [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in pool[:tr["checked_steps"] * tr["accum"]]]
    want = ref_train.run_steps(cfg, ref.seeded_params(cfg, tr["img"], 3, "cpu"), data,
                               train_driver.optimizer_settings(cfg, tr), tr["checked_steps"])
    assert sorted(got["first_grad"]) == sorted(want["first_grad"])
    nums = compare.training(got, want)
    assert nums["loss_gap"] <= 1e-5
    assert nums["grad_gap"] <= 1e-3
    assert nums["change_gap"] <= 1e-3


PLAIN_HEAD = '''
import torch
import torch.nn.functional as F

from benchmark.reference.layers import conv, conv_shapes

PREFIX = "encoder.vit."


def shapes(cfg, img, enc):
    s = enc.shapes(cfg, img, PREFIX)
    s.update(conv_shapes("decoder.out", cfg["markers"], cfg["encoder"]["embed_dim"], 1))
    return s


def forward(cfg, enc, p, x, training, q, checkpoint):
    tokens, _ = enc.forward(cfg, p, PREFIX, x, q, checkpoint=checkpoint)
    y = conv(enc.features(cfg, tokens, x.shape[1]), p["decoder.out.weight"],
             p["decoder.out.bias"], q)
    y = F.interpolate(y, size=tuple(x.shape[1:3]), mode="bilinear", align_corners=False)
    return torch.tanh(y).permute(0, 2, 3, 1)
'''


def test_a_decoder_piece_from_a_file_alone(base, tmp_path, monkeypatch):
    import shutil

    from benchmark.work import model as model_work

    pieces = tmp_path / "reference"
    for folder in ("encoders", "decoders"):
        shutil.copytree(ref.PIECES / folder, pieces / folder)
    (pieces / "decoders" / "plain_head.py").write_text(PLAIN_HEAD)
    monkeypatch.setattr(ref, "PIECES", pieces)
    cfg = _cfg(base, "mipheivit-hoptimus0")
    cfg["decoder"] = {"kind": "plain_head"}
    shapes = ref.param_shapes(cfg, 112)
    assert shapes["decoder.out.weight"] == (16, 64, 1, 1)
    assert any(n.startswith("encoder.vit.blocks.3.") for n in shapes)
    x = serving.normalize(inputs.he_images(2, 112, 5, "cpu"), cfg["he_mean"], cfg["he_std"])
    scfg, p = ref.merged(cfg, ref.seeded_params(cfg, 112, 5, "cpu"))
    with torch.no_grad():
        y = ref.forward(scfg, p, x)
    assert y.shape == (2, 112, 112, 16) and bool(torch.isfinite(y).all())
    assert 0 < model_work.forward_flops(cfg, 112, 2) < model_work.train_flops(cfg, 112, 2)
