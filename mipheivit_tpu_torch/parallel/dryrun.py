"""Dry run of the multi-card paths on the CPU, over N gloo ranks:

  python -m mipheivit_tpu_torch.parallel.dryrun --ranks 8

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``, at tiny
shapes with the real structure (a LoRA ViT encoder, the decoder and the
PatchGAN):

- the data-parallel training step over N ranks, with the GAN: finite
  losses, the first microbatch's loss equal to one process's at the same
  global batch, replicas bit-identical after two optimizer steps;
- data-parallel whole-slide inference over N replicas in one process
  (``make_data_mesh``), equal to one replica's stitch;
- the sequence-sharded ViT forward over a ``dp x sp`` mesh of the N ranks
  (sp = 4 from 8 ranks on, else N / 2), equal to the unsharded forward;
- the tensor-parallel half of the JAX dry run: the same training step with
  the encoder sharded over a ``dp x tp`` mesh (tp = 2 from 4 ranks on, an
  even count, the JAX ``n_model`` rule; skipped below): finite losses, the
  first microbatch's loss equal to one process's at the same global batch,
  the replicated tensors bit-identical on every rank and each shard
  identical across the data replicas.

Exits 0 and prints one summary line when every check holds.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import workers
from .mesh import make_data_mesh
from .spawn import spawn

VIT = dict(img_size=(32, 32), patch_size=4, embed_dim=64, depth=2, num_heads=2,
           mlp_hidden_dim=128, reg_tokens=4, no_embed_class=True, lora_rank=2)
SEQ_VIT = dict(img_size=(128, 128), patch_size=16, embed_dim=64, depth=2, num_heads=2,
               mlp_hidden_dim=128, reg_tokens=0, class_token=False, no_embed_class=True)
OUT = 16


def _state(kw, out_chans, seed):
    torch.manual_seed(seed)
    model = workers.build_generator(kw, out_chans, device="cpu")
    return {k: v.numpy() for k, v in model.state_dict().items()}


def train_spec(n: int, rng) -> dict:
    """The training step's inputs at a global batch of 2 n: the LoRA ViT
    and decoder, the PatchGAN, four microbatches (two optimizer steps)."""
    from ..models.discriminator import DiscriminatorPatch

    torch.manual_seed(1)
    disc = DiscriminatorPatch(3 + OUT, ndf=8, n_layers=2)
    b = 2 * n
    return dict(vit=VIT, out_chans=OUT, state=_state(VIT, OUT, 0),
                disc_state={k: v.numpy() for k, v in disc.state_dict().items()},
                batches=[{"image": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
                          "target": rng.uniform(-0.9, 0.9, (b, 32, 32, OUT)).astype(np.float32)}
                         for _ in range(4)],
                weights=np.ones(OUT, np.float32), lr=1e-3, total_iters=100, warmup=2, accum=2,
                return_state=False)


def _first_loss_matches(ranks, solo) -> dict:
    first = ranks[0]["losses"][0]
    assert all(np.isfinite(v) for r in ranks for step in r["losses"] for v in step.values()), \
        "non-finite loss"
    want = solo["losses"][0]["gen_loss_sim"]
    assert abs(first["gen_loss_sim"] - want) <= 1e-5 * abs(want), (first, want)
    return first


def train_check(n: int, spec: dict, solo: dict) -> str:
    ranks = spawn(workers.train_steps, n, (spec,), device="cpu", timeout=600)
    first = _first_loss_matches(ranks, solo)
    assert len({r["digest"] for r in ranks}) == 1, "generator replicas differ"
    assert len({r["disc_digest"] for r in ranks}) == 1, "discriminator replicas differ"
    return (f"train OK [dp={n}] gen_loss={first['gen_loss']:.4f} "
            f"disc_loss={first['disc_adv_loss']:.4f}, replicas identical after "
            f"{ranks[0]['step']} microbatches")


def wsi_check(n: int, rng) -> str:
    from ..data.stats import Normalizer
    from ..infer.wsi import ArraySlide, wsi_inference

    model = workers.build_generator(VIT, OUT, _state(VIT, OUT, 2), device="cpu").eval()
    image = rng.integers(60, 255, (128, 128, 3), dtype=np.uint8)
    norm = Normalizer({"mean": [180.0] * 3, "std": [40.0] * 3}, "he")
    kw = dict(tile_size=32, overlap=8, batch_size=n, tissue_only=False)
    outs, stats = [], {}
    for mesh in (make_data_mesh(n, ["cpu"] * n), None):
        out = np.zeros((OUT, 128, 128), np.uint8)
        wsi_inference(model, ArraySlide(image), out, [f"m{i}" for i in range(OUT)], norm,
                      mesh=mesh, stats=stats, **kw)
        outs.append(out)
    assert np.array_equal(outs[0], outs[1]), "the replicas' stitch differs from one replica's"
    return f"wsi OK [dp={n}] {stats['n_tiles']} windows stitched"


def seq_check(n: int, rng) -> str:
    if n < 2:
        return "seq_shard SKIPPED (needs >= 2 ranks)"
    n_sp = 4 if n >= 8 else max(2, n // 2)
    n_dp = n // n_sp
    state = _state(SEQ_VIT, None, 3)
    x = rng.standard_normal((n_dp, 128, 128, 3)).astype(np.float32)
    ranks = spawn(workers.forward, n_dp * n_sp, (SEQ_VIT, None, state, x, n_sp), device="cpu",
                  timeout=600)
    got = np.concatenate([ranks[d * n_sp] for d in range(n_dp)])
    model = workers.build_generator(SEQ_VIT, None, state, device="cpu").eval()
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)
    return f"seq_shard OK [dp={n_dp} x sp={n_sp}] {(128 // 16) ** 2} tokens/region match"


def tp_check(n: int, spec: dict, solo: dict) -> str:
    n_tp = 2 if n >= 4 and n % 2 == 0 else 1
    if n_tp == 1:
        return "tp SKIPPED (needs an even count >= 4 ranks)"
    ranks = spawn(workers.train_steps, n, (dict(spec, n_model=n_tp, tp=True),), device="cpu",
                  timeout=600)
    first = _first_loss_matches(ranks, solo)
    assert len({r["digest"] for r in ranks}) == 1, "replicated tensors differ between ranks"
    assert len({r["disc_digest"] for r in ranks}) == 1, "discriminator replicas differ"
    for m in range(n_tp):
        assert len({r["shard_digest"] for r in ranks[m::n_tp]}) == 1, \
            f"model rank {m}'s shards differ between data replicas"
    assert len({r["shard_digest"] for r in ranks[:n_tp]}) == n_tp, "the shards are not split"
    return (f"tp OK [dp={n // n_tp} x tp={n_tp}] gen_loss={first['gen_loss']:.4f} "
            f"disc_loss={first['disc_adv_loss']:.4f}, replicated tensors identical on {n} "
            f"ranks and shards across {n // n_tp} data replicas after {ranks[0]['step']} "
            "microbatches")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=8)
    args = parser.parse_args(argv)
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    spec = train_spec(args.ranks, rng)
    solo = workers.train_steps(dict(spec, disc_state=None))
    parts = [train_check(args.ranks, spec, solo), wsi_check(args.ranks, rng),
             seq_check(args.ranks, rng), tp_check(args.ranks, spec, solo)]
    print(f"dryrun({args.ranks} ranks) OK: {' / '.join(parts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
