"""``train_patchgan`` over 2 gloo ranks on the CPU: the synthetic run of
``tests/test_torch_trainer.py`` (8 training tiles of 32 px, the tiny ViT,
2 epochs), each rank taking 2 rows of a global batch of 4.

- against one process at the same global batch (``train.batch_size`` 4):
  the logged epoch metrics within 1e-5 relative (validation's pixel sums
  are summed over the ranks; the validation loss, a mean over padded
  batches, only finite), the weights within 1e-5, and the replicas
  bit-identical;
- rank 0 alone writes (every other rank raises on a write) and the metrics
  file has one process's lines;
- the preemption cycle of ``tests/test_multihost_trainer.py``: SIGTERM to
  rank 1 alone after its first step, both ranks snapshot at the same step
  boundary, ``status.txt`` reads ``preempted``, and the resumed run
  finishes both epochs;
- ``Loader.shard`` walks the JAX package's indices.
"""

import json

import numpy as np
import pytest
import torch

import torch_synthetic_run as syn
from mipheivit_tpu_torch.config import compose
from mipheivit_tpu_torch.parallel import workers
from mipheivit_tpu_torch.parallel.spawn import spawn

torch.set_num_threads(2)

RTOL = 1e-5
CLOCK_KEYS = ("time", "input_decode_ms_per_batch", "input_wait_ms_per_batch", "input_batches")
# the mean of the batches' losses, whose padding rows (copies of a split's
# last tile, as in the JAX trainer) differ with the shard count: finite only
PADDED_MEANS = ("val_gen_loss_sim", "test_gen_loss_sim")


def _cfg(values, cells=False, **overrides):
    return syn.configure(compose(["+default_configs=miphei-vit"]), values, cells=cells,
                         **overrides).to_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    values = syn.write_run(root)
    values["model.checkpoint_path"] = str(syn.write_checkpoint(root))
    tiny = syn.TINY
    solo = syn.train(_cfg(values), str(root / "solo"),
                         {"tiny": tiny, "return_params": True, "device": "cpu"})
    ranks = _cfg(values, train__batch_size=2)
    cell_root = root / "cells"
    cell_root.mkdir()
    cell_values = syn.write_run(cell_root, cells=True)
    cell_values["model.checkpoint_path"] = values["model.checkpoint_path"]
    cell_solo = syn.train(_cfg(cell_values, cells=True), str(root / "cell_solo"),
                              {"tiny": tiny, "device": "cpu"})
    first = spawn(workers.tasks, 2, [
        (syn.train, (ranks, str(root / "ddp"), {"tiny": tiny, "guard_writes": True,
                                                     "return_params": True})),
        (syn.train, (ranks, str(root / "pre"), {"tiny": tiny, "guard_writes": True,
                                                     "sigterm": (1, 1)})),
        (syn.train, (_cfg(cell_values, cells=True, train__batch_size=2),
                         str(root / "cell_ddp"), {"tiny": tiny, "guard_writes": True}))],
        device="cpu", timeout=300)
    pre = [r[1] for r in first]
    status_pre = (root / "pre" / "status.txt").read_text()
    resumed = spawn(syn.train, 2, (ranks, str(root / "pre"),
                                       {"tiny": tiny, "guard_writes": True, "resume": True}),
                    device="cpu", timeout=300)
    return {"root": root, "solo": solo, "ddp": [r[0] for r in first], "pre": pre,
            "status_pre": status_pre, "resumed": resumed, "cell_solo": cell_solo,
            "cell_ddp": [r[2] for r in first]}


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_ranks_match_one_process_at_the_same_global_batch(runs):
    solo, ddp = runs["solo"], runs["ddp"]
    assert ddp[0]["digest"] == ddp[1]["digest"]
    assert [r["step"] for r in ddp] == [solo["step"]] * 2 == [4, 4]
    for got, want in zip(ddp[0]["history"], solo["history"]):
        assert set(got) == set(want)
        for key, value in want.items():
            if key in CLOCK_KEYS:
                continue
            if key in PADDED_MEANS:
                assert np.isfinite(got[key]), key
                continue
            assert abs(got[key] - value) <= RTOL * abs(value) + 1e-7, (key, got[key], value)
    for name, value in ddp[0]["params"].items():
        np.testing.assert_allclose(value, solo["params"][name], rtol=RTOL, atol=1e-6,
                                   err_msg=name)


def test_cell_loss_and_cell_metrics_over_ranks_match_one_process(runs):
    """With the cell loss and cell metrics on (``monitor: val_cell_auc``):
    the cell loss's means run over every rank's nuclei, and validation's
    cell tables are gathered to rank 0, so the logged epochs equal one
    process's; the other rank logs no cell keys."""
    want, (got, other) = runs["cell_solo"]["history"], runs["cell_ddp"]
    assert got["digest"] == other["digest"]
    assert len(got["history"]) == len(want) == 3
    for g, w in zip(got["history"], want):
        assert set(g) == set(w)
        assert any("_cell_" in k for k in w) and ("epoch" not in w or "loss_cell" in w)
        for key, value in w.items():
            if key in CLOCK_KEYS:
                continue
            if key in PADDED_MEANS:
                assert np.isfinite(g[key]), key
                continue
            assert abs(g[key] - value) <= RTOL * abs(value) + 1e-7, (key, g[key], value)
    assert not any("_cell_" in k for h in other["history"] for k in h)


def test_rank_0_alone_writes(runs):
    """The other rank had every writer patched to raise, and the run's files
    are one process's: its metrics lines, its snapshots, its export."""
    root = runs["root"]
    got, want = _lines(root / "ddp" / "metrics.jsonl"), _lines(root / "solo" / "metrics.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert (root / "ddp" / "status.txt").read_text() == "finished"
    assert (root / "ddp" / "model.safetensors").exists()
    assert (root / "ddp" / "config.yaml").exists()
    assert sorted(p.name for p in (root / "ddp" / "snapshots").iterdir()) == \
        sorted(p.name for p in (root / "solo" / "snapshots").iterdir())


def test_sigterm_on_one_rank_preempts_both_at_one_step_and_resume_finishes(runs):
    pre, resumed = runs["pre"], runs["resumed"]
    assert all(r["preempted"] for r in pre)
    # the flag is agreed at the epoch's end: both ranks stop after its 2 steps
    assert [r["step"] for r in pre] == [2, 2]
    assert pre[0]["digest"] == pre[1]["digest"]
    assert runs["status_pre"] == "preempted"
    assert not any(r["preempted"] for r in resumed)
    assert [r["step"] for r in resumed] == [4, 4]
    assert resumed[0]["digest"] == resumed[1]["digest"]
    # the resumed run ends where the uninterrupted one does
    assert resumed[0]["digest"] == runs["ddp"][0]["digest"]
    root = runs["root"] / "pre"
    assert (root / "status.txt").read_text() == "finished"
    assert (root / "model.safetensors").exists()


def test_loader_shard_walks_the_jax_indices():
    """``Loader.shard(i, n)``: the JAX Loader's ``idx[i::n]`` of the epoch's
    (shuffled or sampled) order, for every shard."""
    from mipheivit_tpu.data.pipeline import Loader as JaxLoader
    from mipheivit_tpu_torch.data.pipeline import Loader

    class Rows:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def reset(self):
            pass

        def __getitem__(self, i, rng=None):
            return {"i": np.asarray([i]), "draw": np.asarray([rng.integers(0, 1 << 30)])}

    for n_shards in (2, 3):
        for shard in range(n_shards):
            port = Loader(Rows(11), 2, shuffle=True, drop_last=True, seed=5).shard(shard,
                                                                                  n_shards)
            jax_loader = JaxLoader(Rows(11), 2, shuffle=True, drop_last=True,
                                   seed=5).shard(shard, n_shards)
            got = np.concatenate([b["i"][:, 0] for b in port])
            want = np.concatenate([b["i"][:, 0] for b in jax_loader])
            np.testing.assert_array_equal(got, want)
            assert len(port) == len(jax_loader)
    # a sample's augmentation draw follows its place in the epoch, whatever
    # the shard count
    whole = Loader(Rows(12), 4, shuffle=True, drop_last=True, seed=5)
    draws = {int(i): int(d) for b in whole for i, d in zip(b["i"][:, 0], b["draw"][:, 0])}
    for shard in range(2):
        part = Loader(Rows(12), 2, shuffle=True, drop_last=True, seed=5).shard(shard, 2)
        for b in part:
            for i, d in zip(b["i"][:, 0], b["draw"][:, 0]):
                assert draws[int(i)] == int(d)


def test_dryrun_over_two_ranks(capsys):
    """``python -m mipheivit_tpu_torch.parallel.dryrun --ranks 2``: the
    data-parallel step with the GAN, the data-parallel WSI and the
    sequence-sharded forward, each held by its own check; the
    tensor-parallel part needs 4 ranks (the JAX ``n_model`` rule) and says
    so."""
    from mipheivit_tpu_torch.parallel import dryrun

    dryrun.main(["--ranks", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun(2 ranks) OK: train OK [dp=2]") and "seq_shard OK" in line
    assert "tp SKIPPED" in line


def test_dryrun_over_four_ranks_shards_the_encoder(capsys):
    """``--ranks 4``: the same step with the encoder tensor-parallel over a
    dp 2 x tp 2 mesh: finite losses, the first loss one process's, the
    replicated tensors bit-identical on every rank and each shard across
    the data replicas (``dryrun.tp_check``)."""
    from mipheivit_tpu_torch.parallel import dryrun

    dryrun.main(["--ranks", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun(4 ranks) OK: train OK [dp=4]")
    assert "seq_shard OK [dp=2 x sp=2]" in line and "tp OK [dp=2 x tp=2]" in line


def test_run_cli_under_two_ranks_trains_into_one_log_directory(tmp_path, monkeypatch):
    """``python -m mipheivit_tpu_torch.run`` as torchrun starts it on 2 ranks:
    both agree on rank 0's log directory, which alone holds the run's files
    and reads ``finished``."""
    root = tmp_path / "data"
    root.mkdir()
    values = syn.write_run(root)
    monkeypatch.chdir(tmp_path)
    argv = ["+default_configs=miphei-vit", "++train.epochs=1", "++train.batch_size=2",
            "++train.callbacks.modelcheckpoint.monitor=val_gen_loss_sim",
            "++train.callbacks.modelcheckpoint.mode=min", "--device=cpu"]
    argv += [f"++{k}={json.dumps(v) if not isinstance(v, str) else v}"
             for k, v in values.items()]
    logdirs = spawn(syn.cli, 2, ("run", argv, syn.TINY), device="cpu", timeout=240)
    assert logdirs[0] == logdirs[1]
    assert [p.name for p in (tmp_path / "logs").iterdir()] == [logdirs[0].name]
    assert (tmp_path / logdirs[0] / "status.txt").read_text() == "finished"
    assert (tmp_path / logdirs[0] / "model.safetensors").exists()


def test_init_distributed_never_maps_a_rank_to_a_missing_or_shared_card(monkeypatch):
    """A rank takes ``cuda:{LOCAL_RANK}``: without a card, or with fewer
    cards than the local rank needs, it raises before any process group
    starts (sharing a card needs the device named)."""
    import torch.distributed as dist

    from mipheivit_tpu_torch.parallel import init_distributed

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        init_distributed()
    assert not dist.is_initialized()
