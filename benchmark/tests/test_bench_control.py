"""``correct`` comes out false where it must.

On the CPU, at test sizes and with the cells' own limits, a run is driven
with the timed path broken underneath: a served answer altered where it is
produced (tiles), a training step that returns its state unchanged,
and one whose optimizer takes the mean over half of the batch. On the card
(``-m gpu``) each cell's control runs at the cell's own size (the program's
int8 path, or the reference in float8 e4m3 in its place) and fails a limit."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture()
def base(tmp_path, monkeypatch):
    b = tiny.make(tmp_path, loose=False)
    tiny.patch_specs(monkeypatch, b)
    return b


def _altered(fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        return (out.float() + 48.0).clamp(max=255.0).to(out.dtype)
    return wrapped


@pytest.mark.parametrize("name", ["hopt0-tiles256", "uni2h-tiles256"])
def test_altered_tile_answers_are_caught(base, monkeypatch, name):
    from mipheivit_tpu_torch.infer import tiles

    assert tiny.run(base, name)["correct"]
    monkeypatch.setattr(tiles, "_to_uint8", _altered(tiles._to_uint8))
    assert not tiny.run(base, name)["correct"]


def _unchanged(step):
    def wrapped(self, params, grads, state, **kw):
        return False
    return wrapped


def _half_batch(step):
    def wrapped(self, params, grads, state, **kw):
        if self.k > 1 and state.mini_step % self.k:
            grads = [a.clone() for a in state.acc]
        return step(self, params, grads, state, **kw)
    return wrapped


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_training_faults_are_caught(base, monkeypatch, fault):
    from mipheivit_tpu_torch.train import optim

    assert tiny.run(base, "hopt0-train1024")["correct"]
    monkeypatch.setattr(optim.AdamChain, "step", fault(optim.AdamChain.step))
    assert not tiny.run(base, "hopt0-train1024")["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["uni2h-tiles256", "hopt0-train1024", "hopt0-tiles256"])
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.Cell(name)
    driver = harness.load_module(cell.driver_path, f"driver_{cell.traffic['driver']}")
    r = harness.Run(cell, 424242, 5.0, False, torch.device("cuda", 0))
    _, nums = driver.control(r)
    assert any(nums[k] > v for k, v in cell.limits.items())
