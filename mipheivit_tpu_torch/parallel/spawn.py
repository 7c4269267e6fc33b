"""Run a function on N ranks in fresh processes (the tests, the chip smoke
and the dry run use it in place of torchrun).

``spawn(fn, n, args)`` starts ``n`` processes with the ``spawn`` start
method, sets torchrun's variables in each (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR=127.0.0.1`` and a free ``MASTER_PORT``),
starts the process group through ``init_distributed(device, backend)`` and
calls ``fn(*args)``; each rank's return value comes back to the caller,
in rank order. A rank that raises, dies or outlives ``timeout`` fails the
call: the other ranks are killed, never left waiting in a collective.
``fn`` must be importable by name (a module-level function).
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, device, backend, threads, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        import torch
        import torch.distributed as dist

        from .mesh import init_distributed

        if threads:
            torch.set_num_threads(threads)
        init_distributed(device, backend)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, n: int, args: Sequence[Any] = (), device=None,
          backend: Optional[str] = None, timeout: float = 300.0,
          threads: Optional[int] = 1) -> List[Any]:
    """``[fn(*args) on rank 0, ..., on rank n-1]``, each rank in its own
    process with the process group started on ``device`` (default: each
    rank's own card, ``cuda:{rank}``) over ``backend`` (default: NCCL on
    cards, gloo on the CPU). ``threads`` sets each rank's intra-op threads
    (None: torch's default). One thread a rank by default: in any fresh
    process on a two-thread team under CPU load, spawned or not, the first
    multi-threaded ``torch.logsumexp`` sometimes returns the rows of one
    thread's half about 4e-5 off (the matmul before it is bit-identical,
    the same call repeated at once matches the f64 reference to 4e-7, and a
    first exp or log pass over a large tensor removes it), so the ranks'
    results were not reproducible from run to run. Raises ``RuntimeError``
    with the failing rank's traceback, or ``TimeoutError``, after killing
    every rank."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, port, device, backend, threads, tuple(args), results))
             for r in range(n)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(out)} of {n} ranks had not finished after "
                                   f"{timeout:.0f} s")
            try:
                r, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if i not in out and p.exitcode is not None]
                if dead:
                    # a rank can exit between its put and our get: drain first
                    try:
                        r, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out[r] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
