"""Training entry point on PyTorch (the root ``run.py``'s counterpart).

Usage:
  python -m mipheivit_tpu_torch.run [+default_configs=miphei-vit] [++train.epochs=15] ...
         [-m] [--resume=LOGDIR] [--device=cpu]

Composes the run config from the port's own YAML tree (``configs/``) and
trains into ``logs/patchgan_<markers>_<timestamp>/``: the resolved
``config.yaml``, a ``status.txt`` that reads ``not finished`` until the run
ends (``finished``, or ``preempted`` after a SIGTERM), and a
``github_log.txt`` with the git SHA and diff (reference: run.py:16-72).
``-m`` runs a sweep (``'glob(*)'`` or comma lists) as sequential jobs under
``logs/multirun_<timestamp>/``; ``--resume=LOGDIR`` continues a run from
its newest snapshot. Trains on the card unless ``--device=cpu`` is given;
without a card it raises. Composing needs PyYAML (this entry point only).

Over several cards, launch it through torchrun, one process a card:

  python -m torch.distributed.run --nproc_per_node N -m mipheivit_tpu_torch.run ...
         [++model.attn_impl=seq_shard ++train.mesh.num_model_shards=M]

Each rank starts the process group (``parallel.init_distributed``: NCCL,
``cuda:{LOCAL_RANK}``; gloo with ``--device=cpu``), rank 0 names the log
directory and writes its files, and ``train_patchgan`` trains the
``N/M x M`` mesh.
"""

import logging
import subprocess
from datetime import datetime
from pathlib import Path


def write_github_logs(logdir: Path) -> None:
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             text=True).stdout.strip()
        diff = subprocess.run(["git", "diff"], capture_output=True, text=True).stdout
        (logdir / "github_log.txt").write_text(f"commit {sha}\n\n{diff}")
    except OSError:
        pass


def main(argv=None) -> Path:
    """Run the training job(s) of ``argv`` (default: the command line);
    returns the run's log directory (the sweep's, with ``-m``)."""
    import sys

    from .config import compose, compose_multirun, load_yaml
    from .train.trainer import train_patchgan

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = list(sys.argv[1:] if argv is None else argv)
    resume_dir, multirun, device = None, False, None
    for arg in list(args):
        if arg.startswith("--resume="):
            resume_dir = arg.split("=", 1)[1]
            args.remove(arg)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
            args.remove(arg)
        elif arg in ("-m", "--multirun"):
            multirun = True
            args.remove(arg)
    from .parallel.mesh import init_distributed, world_size

    main_rank = True
    if world_size() > 1:
        import torch.distributed as dist

        init_distributed(device)
        main_rank = dist.get_rank() == 0
    if resume_dir:
        logdir = Path(resume_dir)
        train_patchgan(load_yaml(logdir / "config.yaml"), str(logdir), resume=True,
                       device=device)
        return logdir
    timestamp = _agreed(datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    if main_rank:
        Path("logs").mkdir(exist_ok=True)
    if multirun:
        # Hydra's -m basic sweeper: sequential jobs, one logdir per job
        # (reference: README.md:193-197)
        jobs = compose_multirun(args)
        sweep_dir = Path("logs") / f"multirun_{timestamp}"
        for i, (name, cfg) in enumerate(jobs):
            logdir = sweep_dir / f"{i}_{name}"
            if main_rank:
                logdir.mkdir(parents=True)
                (logdir / "status.txt").write_text("not finished")
                write_github_logs(logdir)
            logging.info("multirun job %d/%d: %s", i + 1, len(jobs), name)
            train_patchgan(cfg, str(logdir), device=device)
        return sweep_dir
    cfg = compose(args)
    markers = "_".join(map(str, cfg.data.targ_channel_names))
    logdir = Path("logs") / f"patchgan_{markers}_{timestamp}"
    if main_rank:
        logdir.mkdir(parents=True)
        (logdir / "status.txt").write_text("not finished")
        write_github_logs(logdir)
    train_patchgan(cfg, str(logdir), device=device)
    return logdir


def _agreed(value: str) -> str:
    """Rank 0's ``value`` on every rank (the log directory's timestamp)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


if __name__ == "__main__":
    main()
