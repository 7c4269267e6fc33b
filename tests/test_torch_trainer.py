"""The port's training driver against the JAX package's, on the CPU.

The synthetic run of ``tests/test_trainer_e2e.py`` (12 tiles of 32 px, the
tiny ViT, 2 epochs of batch 4, monitor ``val_gen_loss_sim``/min, cell
metrics off; ``tests/torch_synthetic_run.py`` writes its tiles as TIFF).
Both packages start from one safetensors checkpoint through
``model.checkpoint_path``; with the GAN on, the port's discriminator starts
from the JAX one's initial weights and draws the JAX step's label noise.
The tolerances are ``tests/test_torch_train.py``'s. The same run with
nuclei tiles, a slide dataframe, cell metrics and the cell loss on and
``val_cell_auc``/max monitored holds its cell keys within the tolerances
of ``tests/test_torch_cell_metrics.py`` (every AUC 2e-3, balanced accuracy
and F1 1e-2), and ``test_model``'s ``test_dataframe_cell.csv`` within its
table tolerances.
"""

import json
import logging
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

import mipheivit_tpu_torch.infer.loading as port_loading
import mipheivit_tpu_torch.train.steps as port_steps
import mipheivit_tpu_torch.train.trainer as port_trainer
from mipheivit_tpu_torch.config import compose
from mipheivit_tpu_torch.io.safetensors import load_file
from mipheivit_tpu_torch.train.schedule import pix2pix_schedule, scaled_lr

import torch_synthetic_run as syn
from test_torch_train import LOSS_RTOL, STAT_ATOL, _assert_moved_like

torch.set_num_threads(2)

# wall-clock fields of metrics.jsonl: compared for presence only
CLOCK_KEYS = ("time", "input_decode_ms_per_batch", "input_wait_ms_per_batch")
# SSIM of random predictions is ~1e-3: an absolute floor, as in test_torch_train.py
SSIM_ATOL = 1e-7
N_NOISE_DRAWS = 16
# the cell metrics' keys: the tolerances of tests/test_torch_cell_metrics.py
CELL_AUC_ATOL, CELL_HARD_ATOL = 2e-3, 1e-2


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    values = syn.write_run(root)
    values["model.checkpoint_path"] = str(syn.write_checkpoint(root))
    return root, values


@pytest.fixture(scope="module")
def cell_workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_cells")
    values = syn.write_run(root, cells=True)
    values["model.checkpoint_path"] = str(syn.write_checkpoint(root))
    return root, values


@pytest.fixture
def tiny_port(monkeypatch):
    monkeypatch.setattr(port_loading, "get_generator", syn.tiny_generator)
    monkeypatch.setattr(port_trainer, "get_generator", syn.tiny_generator)


def _port_cfg(values, cells=False, **overrides):
    return syn.configure(compose(["+default_configs=miphei-vit"]), values, cells=cells,
                         **overrides)


def _jax_tiny(monkeypatch):
    import mipheivit_tpu.infer.loading as jax_loading
    import mipheivit_tpu.train.trainer as jax_trainer
    from mipheivit_tpu.models import MipheiViT, ViTConfig

    tiny = ViTConfig(attn_impl="xla", remat=False, **syn.TINY)
    monkeypatch.setattr(jax_trainer, "get_generator",
                        lambda name, w, ci, co, cfg, dtype="float32":
                        MipheiViT(vit_cfg=tiny, out_chans=co))
    monkeypatch.setattr(jax_loading, "build_generator",
                        lambda cfg, img_size, nc_out, dtype="float32":
                        MipheiViT(vit_cfg=tiny, out_chans=nc_out))


_JAX_RUNS = {}


def _jax_run(workspace, gan: bool, cells: bool = False) -> Path:
    """The JAX trainer on the workspace (once per setting per module)."""
    if (gan, cells) not in _JAX_RUNS:
        from mipheivit_tpu.config import compose as jax_compose
        from mipheivit_tpu.train.trainer import train_patchgan

        root, values = workspace
        logdir = root / f"jax_gan{int(gan)}"
        cfg = syn.configure(jax_compose(["+default_configs=miphei-vit"]), values, cells=cells,
                            train__gan_train=gan)
        with pytest.MonkeyPatch.context() as mp:
            _jax_tiny(mp)
            train_patchgan(cfg, str(logdir), dtype="float32", use_wandb=False)
        _JAX_RUNS[gan, cells] = logdir
    return _JAX_RUNS[gan, cells]


def _jax_discriminator(monkeypatch):
    """Make the port's trainer build its discriminator with the JAX one's
    initial weights (``create_train_state``: key ``fold_in(PRNGKey(seed),
    1)``) and draw the JAX step's label noise, in the JAX step's order."""
    import jax
    import jax.numpy as jnp

    from mipheivit_tpu.models.discriminator import DiscriminatorPatch as JaxDisc
    from mipheivit_tpu_torch.models.convert import discriminator_state_dict_from_jax
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch

    x, y = jnp.zeros((4, 32, 32, 3)), jnp.zeros((4, 32, 32, len(syn.MARKERS)))
    jd = JaxDisc(norm_layer_type=None, selected_channels=[0])   # CD31 is the structural one
    variables = jax.tree.map(np.asarray, jd.init(
        jax.random.fold_in(jax.random.PRNGKey(0), 1), x, y, train=False))
    state = {k: torch.from_numpy(np.array(v))
             for k, v in discriminator_state_dict_from_jax(variables).items()}

    def build(in_chans, selected_channels=None):
        assert selected_channels == [0]
        disc = DiscriminatorPatch(in_chans, selected_channels=selected_channels)
        disc.load_state_dict(state)
        return disc

    shape = jd.apply(variables, x, y, train=False).shape
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(N_NOISE_DRAWS // 2):
        key, _, d_key = jax.random.split(key, 3)
        for k in jax.random.split(d_key):
            draws.append(torch.from_numpy(np.array(jax.random.uniform(k, shape))))
    it = iter(draws)
    monkeypatch.setattr(port_trainer, "DiscriminatorPatch", build)
    monkeypatch.setattr(port_steps, "_label_noise", lambda shape, gen: next(it))


def _lines(logdir: Path):
    return [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]


def _assert_value_matches(key, got, want, err_msg):
    if "_cell_" in key:
        atol = CELL_AUC_ATOL if "_cell_auc" in key else CELL_HARD_ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=err_msg)
    else:
        atol = SSIM_ATOL if "ssim" in key else 0.0
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=atol, err_msg=err_msg)


def _assert_lines_match(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, set(g) ^ set(w))
        for key, value in w.items():
            if key in CLOCK_KEYS:
                continue
            if isinstance(value, float):
                _assert_value_matches(key, g[key], value, f"line {i}: {key}")
            else:
                assert g[key] == value, (i, key, g[key], value)


@pytest.mark.parametrize("gan", [False, True])
def test_train_patchgan_matches_jax(workspace, tiny_port, monkeypatch, gan):
    """Every line of ``metrics.jsonl`` and the exported best checkpoint."""
    from mipheivit_tpu_torch.train.trainer import train_patchgan

    want_dir = _jax_run(workspace, gan)
    if gan:
        _jax_discriminator(monkeypatch)
    root, values = workspace
    got_dir = root / f"port_gan{int(gan)}"
    out = train_patchgan(_port_cfg(values, train__gan_train=gan), str(got_dir),
                         use_wandb=False, device="cpu")
    lines = _lines(got_dir)
    _assert_lines_match(lines, _lines(want_dir))
    assert (gan and "disc_adv_loss" in lines[0]) or (not gan and "disc_adv_loss" not in lines[0])
    assert (got_dir / "status.txt").read_text() == "finished"
    assert (got_dir / "logs_img" / "step1.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out["state"].step == 4

    # the best epoch's export (epoch 0 or 1, as the JAX run chose)
    best_epoch = min(range(2), key=lambda e: lines[e]["val_gen_loss_sim"])
    _assert_export_matches(got_dir, want_dir, values, best_epoch, out["state"])


def _assert_export_matches(got_dir, want_dir, values, best_epoch, state):
    """``model.safetensors`` of both runs: frozen weights as loaded, the
    trainable ones moved like the JAX run's after ``best_epoch``'s updates,
    BatchNorm statistics within ``STAT_ATOL``."""
    got, want = load_file(got_dir / "model.safetensors"), load_file(want_dir / "model.safetensors")
    before = load_file(values["model.checkpoint_path"])
    assert set(got) == set(want)
    n_updates = 2 * (best_epoch + 1)
    # the lr-scaled budget of test_torch_train.py, summed over the updates
    lr_step = scaled_lr(2e-4, 4) * sum(pix2pix_schedule(1.0, 4)(c) for c in range(n_updates))
    trainable = {n for n, _ in state.gen_params}
    for name, value in got.items():
        value, ref = value.numpy(), want[name].numpy()
        if name.endswith("num_batches_tracked"):
            continue    # the JAX export writes 0; torch counts the training batches
        if "running_" in name:
            np.testing.assert_allclose(value, ref, atol=STAT_ATOL, err_msg=name)
        elif name in trainable:
            _assert_moved_like(value, ref, before[name].numpy(), lr_step, name)
        else:
            np.testing.assert_array_equal(value, ref, err_msg=name)
            np.testing.assert_array_equal(value, before[name].numpy(), err_msg=name)


def _state_tensors(state):
    out = {f"gen.{k}": v for k, v in state.generator.state_dict().items()}
    if state.disc is not None:
        out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    for tag, opt in (("gen_opt", state.gen_opt_state), ("disc_opt", state.disc_opt_state)):
        if opt is not None:
            for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
                out[f"{tag}.mu.{i}"], out[f"{tag}.nu.{i}"] = m, v
    return out


def test_resume_after_one_epoch_equals_two_straight(workspace, tiny_port, tmp_path):
    """A run stopped after epoch 0 and resumed from its snapshot ends bit
    for bit where the straight run ends: weights, buffers, Adam moments,
    the discriminator and its label-noise generator (GAN on)."""
    from mipheivit_tpu_torch.train.checkpoints import latest_checkpoint
    from mipheivit_tpu_torch.train.trainer import train_patchgan

    _, values = workspace
    straight = train_patchgan(_port_cfg(values, train__gan_train=True), str(tmp_path / "straight"),
                              use_wandb=False, device="cpu")
    logdir = tmp_path / "resumed"
    train_patchgan(_port_cfg(values, train__gan_train=True, train__epochs=1), str(logdir),
                   use_wandb=False, device="cpu")
    assert Path(latest_checkpoint(logdir / "snapshots")).name == "state_2.pt"
    resumed = train_patchgan(_port_cfg(values, train__gan_train=True), str(logdir),
                             use_wandb=False, device="cpu", resume=True)
    assert resumed["state"].step == straight["state"].step == 4
    want, got = _state_tensors(straight["state"]), _state_tensors(resumed["state"])
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert torch.equal(resumed["state"].rng.get_state(), straight["state"].rng.get_state())
    got, want = ([{k: v for k, v in line.items() if k not in CLOCK_KEYS} for line in lines[-2:]]
                 for lines in (_lines(logdir), _lines(tmp_path / "straight")))
    assert got == want    # epoch 1 and the test epoch


def _small_state(device, seed):
    from mipheivit_tpu_torch.metrics import PixelMetrics
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch
    from mipheivit_tpu_torch.train import losses, optim, steps

    torch.manual_seed(seed)
    model = syn.tiny_generator("myvitmatte", 32, 2)
    disc = DiscriminatorPatch(5, ndf=8, n_layers=2)
    gen_opt, disc_opt = (optim.build_generator_optimizer(1e-3, 10, 1, grad_accum_steps=2)
                         for _ in range(2))
    state = steps.create_train_state(model, gen_opt, disc, disc_opt,
                                     freeze_model_name="myvitmatte", seed=seed, device=device)
    step = steps.make_train_step(model, losses.mse_loss(1.0), gen_opt, disc, disc_opt,
                                 steps.StepConfig(gan_train=True))
    return state, step, PixelMetrics.zeros(device)


def _take_steps(state, step, metrics, n, seed, device):
    g = np.random.default_rng(seed)
    for _ in range(n):
        batch = {"image": torch.from_numpy(g.standard_normal((2, 32, 32, 3), np.float32)),
                 "target": torch.from_numpy(g.uniform(-0.9, 0.9, (2, 32, 32, 2))
                                            .astype(np.float32))}
        state, metrics, _ = step(state, {k: v.to(device) for k, v in batch.items()}, metrics)
    return state


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_snapshot_restores_onto_the_states_device(tmp_path, device):
    """After updates (the Adam moments are the tuples ``torch._foreach_*``
    returns) and mid-accumulation, a snapshot restored into a fresh state
    puts every tensor on the state's device, and both states continue
    alike. Keeps ``keep_last`` snapshots."""
    from mipheivit_tpu_torch.train.checkpoints import (latest_checkpoint, restore_train_state,
                                                       save_train_state)

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state, step, metrics = _small_state(device, 0)
    state = _take_steps(state, step, metrics, 5, 1, device)      # 2 updates, 1 microbatch over
    for s in range(3, 6):
        save_train_state(state, tmp_path, step=s)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state_4.pt", "state_5.pt"]
    fresh, fresh_step, fresh_metrics = _small_state(device, 7)
    restore_train_state(latest_checkpoint(tmp_path), fresh)
    for opt in (fresh.gen_opt_state, fresh.disc_opt_state):
        assert opt.mini_step == 1 and opt.adam_count == 2
        for seq in (opt.mu, opt.nu, opt.acc):
            assert isinstance(seq, list) and all(t.device.type == device for t in seq)
    state = _take_steps(state, step, metrics, 3, 2, device)
    fresh = _take_steps(fresh, fresh_step, fresh_metrics, 3, 2, device)
    want, got = _state_tensors(state), _state_tensors(fresh)
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_sigterm_snapshots_then_resume_finishes(workspace, tiny_port, tmp_path, monkeypatch):
    """SIGTERM mid-epoch: a snapshot, status.txt ``preempted`` and a clean
    return, with the files the JAX trainer leaves (its snapshot is an
    orbax directory, this one a file); ``resume`` then finishes the run."""
    from mipheivit_tpu_torch.train.checkpoints import latest_checkpoint
    from mipheivit_tpu_torch.train.trainer import train_patchgan

    real = port_trainer.device_prefetch

    def prefetch_and_kill(loader, **kw):
        for j, batch in enumerate(real(loader, **kw)):
            if j == 1:      # after the first training step of epoch 0
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    _, values = workspace
    logdir = tmp_path / "preempt_run"
    previous = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(port_trainer, "device_prefetch", prefetch_and_kill)
    result = train_patchgan(_port_cfg(values), str(logdir), use_wandb=False, device="cpu")
    monkeypatch.setattr(port_trainer, "device_prefetch", real)
    assert signal.getsignal(signal.SIGTERM) is previous
    assert result.get("preempted") is True and result["state"].step == 1
    assert (logdir / "status.txt").read_text() == "preempted"
    assert sorted(str(p.relative_to(logdir)) for p in logdir.rglob("*") if p.is_file()) == [
        "config.yaml", "logs_img/step1.png", "metrics.jsonl", "snapshots/state_1.pt",
        "status.txt"]
    assert latest_checkpoint(logdir / "snapshots").endswith("state_1.pt")

    result = train_patchgan(_port_cfg(values), str(logdir), use_wandb=False, device="cpu",
                            resume=True)
    assert (logdir / "status.txt").read_text() == "finished"
    assert result["state"].step > 1
    assert np.isfinite(result["history"][-1]["test_psnr"])


def test_nan_forensics_name_the_first_step(workspace, tiny_port, tmp_path, monkeypatch):
    """A NaN output at global step 2 is named exactly though the scalars are
    fetched only at the epoch's end; the weights are dumped as the JAX
    trainer dumps them."""
    from mipheivit_tpu_torch.train.trainer import train_patchgan

    real = port_trainer.device_prefetch

    def corrupting(loader, **kw):
        for i, batch in enumerate(real(loader, **kw)):
            if i == 1:
                batch = dict(batch, image=batch["image"] * float("nan"))
            yield batch

    monkeypatch.setattr(port_trainer, "device_prefetch", corrupting)
    _, values = workspace
    logdir = tmp_path / "nan_run"
    with pytest.raises(ValueError, match=r"first at step 2"):
        train_patchgan(_port_cfg(values, train__epochs=1), str(logdir), use_wandb=False,
                       device="cpu")
    assert (logdir / "weights_nan.step").read_text().strip() == "2"
    assert set(load_file(logdir / "weights_nan.safetensors")) == set(
        load_file(workspace[1]["model.checkpoint_path"]))
    assert (logdir / "snapshots" / "state_2.pt").exists()


def test_test_model_matches_jax(workspace, tiny_port, tmp_path, monkeypatch):
    """``run_test``'s driver on one checkpoint dir (the JAX run's export and
    config) in both packages: the val and test pixel metrics."""
    import shutil

    from mipheivit_tpu.config import load_yaml as jax_load_yaml
    from mipheivit_tpu.train.test_driver import test_model as jax_test_model
    from mipheivit_tpu_torch.config import load_yaml
    from mipheivit_tpu_torch.train.test_driver import test_model

    src = _jax_run(workspace, False)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        dirs[side].mkdir()
        for name in ("config.yaml", "model.safetensors"):
            shutil.copy(src / name, dirs[side] / name)
    _jax_tiny(monkeypatch)
    want = jax_test_model(jax_load_yaml(dirs["jax"] / "config.yaml"), str(dirs["jax"]), "td",
                          dtype="float32")
    got = test_model(load_yaml(dirs["port"] / "config.yaml"), str(dirs["port"]), "td",
                     device="cpu")
    assert set(got) == set(want) == {f"{s}_{k}" for s in ("val", "test")
                                     for k in ("psnr", "ssim", "gen_loss_sim")}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL,
                                   atol=SSIM_ATOL if "ssim" in key else 0.0, err_msg=key)
    assert len(_lines(dirs["port"])) == 2


def test_train_patchgan_with_cells_matches_jax(cell_workspace, tiny_port):
    """The flagship preset's cell settings (cell metrics on a slide
    dataframe, the cell loss with MSE and clustering, ``val_cell_auc``/max):
    every line of ``metrics.jsonl``, and the export of the epoch with the
    best ``val_cell_auc``."""
    from mipheivit_tpu_torch.train.trainer import train_patchgan

    want_dir = _jax_run(cell_workspace, False, cells=True)
    root, values = cell_workspace
    got_dir = root / "port_cells"
    out = train_patchgan(_port_cfg(values, cells=True), str(got_dir), use_wandb=False,
                         device="cpu")
    lines = _lines(got_dir)
    _assert_lines_match(lines, _lines(want_dir))
    assert all(line["loss_cell"] > 0 for line in lines[:2])
    assert {"val_cell_auc", "val_cell_f1_CD31_pos", "test_cell_auc_logreg"} <= (
        set(lines[0]) | set(lines[-1]))
    assert np.isfinite(lines[0]["val_cell_auc"]) and out["best"] == max(
        line["val_cell_auc"] for line in lines[:2])
    best_epoch = max(range(2), key=lambda e: (lines[e]["val_cell_auc"], -e))
    _assert_export_matches(got_dir, want_dir, values, best_epoch, out["state"])


def _read_table(path):
    from mipheivit_tpu_torch.data.table import Table

    return Table.read_csv(path)


def assert_csv_matches(got_path, want_path, float_atol=1.0 / 21 + 1e-6):
    """Two CSVs parsed: the same columns and rows, non-float columns equal,
    float columns (the cell means, of the sums quantised at ``* 255``) within
    ``float_atol``: one quantisation step over the smallest area kept."""
    got, want = _read_table(got_path), _read_table(want_path)
    assert got.columns == want.columns and len(got) == len(want) > 0
    for col in want.columns:
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=0, atol=float_atol, err_msg=col)
        else:
            assert got[col].tolist() == want[col].tolist(), col


def test_test_model_with_cells_matches_jax(cell_workspace, tiny_port, tmp_path, monkeypatch):
    """``test_model`` with cell metrics on the JAX cell run's export: the
    val and test metrics, and ``test_dataframe_cell.csv``."""
    import shutil

    from mipheivit_tpu.config import load_yaml as jax_load_yaml
    from mipheivit_tpu.train.test_driver import test_model as jax_test_model
    from mipheivit_tpu_torch.config import load_yaml
    from mipheivit_tpu_torch.train.test_driver import test_model

    src = _jax_run(cell_workspace, False, cells=True)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        dirs[side].mkdir()
        for name in ("config.yaml", "model.safetensors"):
            shutil.copy(src / name, dirs[side] / name)
    _jax_tiny(monkeypatch)
    want = jax_test_model(jax_load_yaml(dirs["jax"] / "config.yaml"), str(dirs["jax"]), "td",
                          dtype="float32")
    got = test_model(load_yaml(dirs["port"] / "config.yaml"), str(dirs["port"]), "td",
                     device="cpu")
    assert set(got) == set(want) and "test_cell_auc" in got and np.isfinite(got["test_cell_auc"])
    for key, value in want.items():
        _assert_value_matches(key, got[key], value, key)
    assert_csv_matches(dirs["port"] / "test_dataframe_cell.csv",
                       dirs["jax"] / "test_dataframe_cell.csv")


def test_run_and_run_test_entry_points(workspace, tiny_port, tmp_path, monkeypatch):
    """``python -m mipheivit_tpu_torch.run`` (a run, a 2-job sweep and a
    resume) and ``.run_test``, in-process, with the root scripts' logs/
    layout."""
    from mipheivit_tpu_torch import run, run_test

    _, values = workspace
    monkeypatch.chdir(tmp_path)
    args = ["+default_configs=miphei-vit", "++train.epochs=1", "++train.batch_size=4",
            "++train.callbacks.modelcheckpoint.monitor=val_gen_loss_sim",
            "++train.callbacks.modelcheckpoint.mode=min", "--device=cpu"]
    args += [f"++{k}={json.dumps(v) if not isinstance(v, str) else v}"
             for k, v in values.items() if k != "model.checkpoint_path"]
    logdir = run.main(args)
    assert logdir.parent == Path("logs") and logdir.name.startswith("patchgan_CD31_CD3e_")
    assert (logdir / "status.txt").read_text() == "finished"
    assert (logdir / "github_log.txt").exists()
    assert (logdir / "model.safetensors").exists()
    results = run_test.main(["--checkpoint_dir", str(logdir), "--device", "cpu"])
    assert np.isfinite(results["test_psnr"]) and np.isfinite(results["val_gen_loss_sim"])

    sweep = run.main(["-m", "train.seed=0,1"] + args)
    jobs = sorted(p.name for p in sweep.iterdir())
    assert jobs == ["0_0", "1_1"]
    assert all((sweep / j / "status.txt").read_text() == "finished" for j in jobs)

    (logdir / "status.txt").write_text("not finished")
    assert run.main([f"--resume={logdir}", "--device=cpu"]) == logdir
    assert (logdir / "status.txt").read_text() == "finished"


@pytest.mark.parametrize("case", ["foreground_head", "seq_shard", "processes",
                                  "tensor_parallel"])
def test_unported_options_raise_before_any_work(workspace, tmp_path, monkeypatch, caplog, case):
    """What the port cannot run raises before any work: the foreground head,
    ported with the SMP U-Net, raises ``ValueError`` on a generator without
    one (the flagship here); ``model.attn_impl=seq_shard`` in one process (no
    ranks to shard the tokens over) raises ``ValueError`` naming
    ``train.mesh.num_model_shards``; ``WORLD_SIZE=2`` without a process group
    raises ``RuntimeError`` in the trainer and in ``test_model``. The
    ``tensor_parallel`` case holds what the trainer does with
    ``train.mesh.model_axis`` set: as the JAX trainer, which never reads the
    key, it trains one step to the losses of the same run without the key,
    and logs that the key has no effect. Both ported layouts train over
    ranks in ``tests/test_torch_parallel_*.py``; ``test_model`` evaluates a
    sequence-sharded run unsharded."""
    from mipheivit_tpu_torch.train.test_driver import test_model
    from mipheivit_tpu_torch.train.trainer import train_patchgan

    _, values = workspace
    if case == "tensor_parallel":
        monkeypatch.setattr(port_loading, "get_generator", syn.tiny_generator)
        monkeypatch.setattr(port_trainer, "get_generator", syn.tiny_generator)
        lines = {}
        for axis in (None, "model"):
            cfg = _port_cfg(values, train__epochs=1, train__mesh__model_axis=axis)
            with caplog.at_level(logging.WARNING, logger=port_trainer.__name__):
                out = train_patchgan(cfg, str(tmp_path / f"run_{axis}"), max_steps_per_epoch=1,
                                     use_wandb=False, device="cpu")
            assert out["state"].step == 1
            lines[axis] = [{k: v for k, v in line.items() if k not in CLOCK_KEYS}
                           for line in _lines(tmp_path / f"run_{axis}")]
        assert lines["model"] == lines[None] and np.isfinite(lines[None][0]["gen_loss"])
        said = [r.getMessage() for r in caplog.records if "model_axis" in r.getMessage()]
        assert len(said) == 1 and "no effect" in said[0]
        return
    overrides = {"foreground_head": {"train__foreground_head": True},
                 "seq_shard": {"model__attn_impl": "seq_shard"},
                 "processes": {}}[case]
    if case == "processes":
        monkeypatch.setenv("WORLD_SIZE", "2")
    error, match = {"foreground_head": (ValueError, "foreground head.*smp_unet"),
                    "seq_shard": (ValueError, "num_model_shards in \\[2, 1\\]"),
                    "processes": (RuntimeError, "WORLD_SIZE=2 but no process group")}[case]
    cfg = _port_cfg(values, **overrides)
    with pytest.raises(error, match=match):
        train_patchgan(cfg, str(tmp_path / "run"), use_wandb=False, device="cpu")
    assert not (tmp_path / "run").exists()
    if case in ("foreground_head", "processes"):
        with pytest.raises(error, match=match):
            test_model(cfg, str(tmp_path / "ckpt"), "ckpt", device="cpu")


@pytest.mark.parametrize("case", ["no_cell_metrics", "no_slide_dataframe"])
def test_cell_loss_without_nuclei_raises_before_any_work(cell_workspace, tmp_path, case):
    """The cell loss needs the nuclei, which only cell metrics on a slide
    dataframe load: a ``ValueError`` naming both settings, before any work
    (the JAX trainer fails at its first step with a ``KeyError``)."""
    from mipheivit_tpu_torch.train.trainer import train_patchgan

    _, values = cell_workspace
    override = {"no_cell_metrics": {"train__use_cell_metrics": False},
                "no_slide_dataframe": {"data__slide_dataframe_path": None}}[case]
    cfg = _port_cfg(values, cells=True, **override)
    with pytest.raises(ValueError, match=r"train\.use_cell_metrics.*data\.slide_dataframe_path"):
        train_patchgan(cfg, str(tmp_path / "run"), use_wandb=False, device="cpu")
    assert not (tmp_path / "run").exists()


def test_swap_augmentation_replicas_matches_jax(workspace, tmp_path):
    """The CycleGAN replica swap draws as the JAX trainer's does and points
    a drawn tile at its copy in ``augmentation_dir`` where one exists."""
    import shutil

    import pandas as pd

    from mipheivit_tpu.train.trainer import swap_augmentation_replicas as jax_swap
    from mipheivit_tpu_torch.data.table import Table
    from mipheivit_tpu_torch.train.trainer import swap_augmentation_replicas

    _, values = workspace
    csv_path = values["data.train_dataframe_path"]
    table = Table.read_csv(csv_path)
    for path in table["image_path"][::2]:          # replicas of every other tile
        shutil.copy(path, tmp_path / Path(path).name)
    for seed in range(4):
        got = swap_augmentation_replicas(table, str(tmp_path), 0.5, np.random.default_rng(seed))
        want = jax_swap(pd.read_csv(csv_path), str(tmp_path), 0.5, np.random.default_rng(seed))
        assert got["image_path"].tolist() == want["image_path"].tolist()
        assert got["target_path"].tolist() == table["target_path"].tolist()
    assert any(str(tmp_path) in p for p in got["image_path"])
