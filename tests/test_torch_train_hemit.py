"""``python -m mipheivit_tpu_torch.hemit.train_hemit`` on the CPU: a few
steps of the GAN + L1 loop on ``.npy`` pairs in HEMIT's folder layout, with
a tiny dual-branch generator, then the best-``val_psnr`` snapshot reloaded
into a fresh train state."""

import json

import numpy as np
import torch

from mipheivit_tpu_torch.hemit import train_hemit
from mipheivit_tpu_torch.models.hemit import ResnetGeneratorSwinT
from mipheivit_tpu_torch.models.swin import SwinConfig

torch.set_num_threads(2)


def _tiny_hemit(img_size, nc_in=3, nc_out=3):
    return ResnetGeneratorSwinT(nc_out, img_size, ngf=8, n_blocks=1, swin_cfg=SwinConfig(
        img_size=(img_size, img_size), patch_size=2, embed_dim=16, depths=(1, 1, 1, 1),
        num_heads=(1, 2, 4, 8), window_size=4))


def _write_pairs(root, n_train=4, n_val=2, size=40):
    g = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_val)):
        for sub in ("input", "label"):
            (root / split / sub).mkdir(parents=True)
        for i in range(n):
            for sub in ("input", "label"):
                np.save(root / split / sub / f"t{i}.npy",
                        g.integers(0, 255, (size, size, 3), dtype=np.uint8))
    np.save(root / "train" / "input" / "unpaired.npy", np.zeros((size, size, 3), np.uint8))


def test_train_hemit_runs_and_its_snapshot_reloads(tmp_path, monkeypatch):
    from mipheivit_tpu_torch.train.checkpoints import latest_checkpoint, restore_train_state
    from mipheivit_tpu_torch.train.optim import (build_discriminator_optimizer,
                                                 build_generator_optimizer)
    from mipheivit_tpu_torch.train.steps import create_train_state
    from mipheivit_tpu_torch.models.discriminator import DiscriminatorPatch

    _write_pairs(tmp_path / "data")
    assert len(train_hemit.dataframe_from_folders(tmp_path / "data", "train")) == 4
    monkeypatch.setattr(train_hemit, "build_hemit", _tiny_hemit)
    out = train_hemit.main(["--data_root", str(tmp_path / "data"), "--out_dir",
                            str(tmp_path / "run"), "--epochs", "2", "--batch_size", "2",
                            "--crop", "32", "--num_workers", "1", "--device", "cpu"])
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["val_psnr"]) and np.isfinite(h["val_ssim"]) for h in out["history"])
    assert out["best_psnr"] == max(h["val_psnr"] for h in out["history"])
    state = out["state"]
    assert state.step == 4 and state.disc is not None
    lines = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]

    path = latest_checkpoint(tmp_path / "run" / "best")
    assert path == out["best_path"]
    fresh = create_train_state(_tiny_hemit(32), build_generator_optimizer(2e-4, 4),
                               DiscriminatorPatch(6), build_discriminator_optimizer(2e-4, 4),
                               device="cpu")
    restore_train_state(path, fresh)
    best_epoch = max(range(2), key=lambda e: out["history"][e]["val_psnr"])
    assert fresh.step == 2 * (best_epoch + 1)
    if best_epoch == 1:
        for (name, p), (_, q) in zip(fresh.generator.named_parameters(),
                                     state.generator.named_parameters()):
            assert torch.equal(p, q), name
