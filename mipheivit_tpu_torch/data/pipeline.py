"""Host input pipeline: threaded decode -> batch -> prefetch onto the card.

The port's copy of ``mipheivit_tpu/data/pipeline.py``. The reference hides
tile-decode latency in ~31 DataLoader worker processes (reference:
src/dataset.py:43). Here decode runs in a thread pool (the native TIFF
engine releases the GIL) feeding a bounded queue; ``device_prefetch`` keeps
the next batches in flight: pinned host buffers copied on a side CUDA
stream while the current batch computes.

Over several ranks, ``Loader.shard(index, n)`` walks ``idx[index::n]`` of
the epoch's order, as the JAX package's per-host sharding does; ``index``
is the rank's coordinate on the data axis, so the ranks of one model group
read the same rows. Each sample's augmentation seed is drawn for its place
in the whole epoch, so that the rows of one global batch see the same
augmentations on any number of ranks. The trainer truncates every rank to
the smallest shard's batch count; ``device_prefetch`` then places a rank's
rows on its own card.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


class PipelineStats:
    """Per-phase timers for the input pipeline (SURVEY.md §5 tracing note:
    the reference has only tqdm; here decode/wait times are measured so
    host-boundedness is visible in metrics.jsonl)."""

    def __init__(self):
        self.decode_s = 0.0
        self.wait_s = 0.0
        self.batches = 0

    def snapshot(self) -> Dict[str, float]:
        n = max(self.batches, 1)
        return {"input_decode_ms_per_batch": 1000.0 * self.decode_s / n,
                "input_wait_ms_per_batch": 1000.0 * self.wait_s / n,
                "input_batches": self.batches}


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack sample dicts; non-array fields become lists."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class Loader:
    """Iterable over batches of a dataset (see data/dataset.py)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, sampler=None, num_workers: int = 4,
                 seed: int = 0, prefetch_batches: int = 4,
                 pad_to_batch: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.pad_to_batch = pad_to_batch
        self.shard_index = 0
        self.num_shards = 1
        self.stats = PipelineStats()

    def shard(self, shard_index: int, num_shards: int) -> "Loader":
        """Walk ``idx[shard_index::num_shards]`` of every epoch's order."""
        self.shard_index = shard_index
        self.num_shards = num_shards
        return self

    def _indices(self, rng) -> np.ndarray:
        if self.sampler is not None:
            idx = np.asarray(self.sampler.epoch_indices())
        else:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        idx = self._indices(rng)
        seeds = None
        if self.num_shards > 1:
            # one seed per place in the whole epoch (the same draws as the
            # batches of one process take in turn), then this shard's
            seeds = rng.integers(0, 2 ** 31, size=len(idx))[self.shard_index::self.num_shards]
            idx = idx[self.shard_index::self.num_shards]
        n_batches = len(idx) // self.batch_size if self.drop_last \
            else -(-len(idx) // self.batch_size)

        self.dataset.reset()
        pool = ThreadPoolExecutor(self.num_workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def fetch_one(i, seed):
            return self.dataset.__getitem__(
                int(i), rng=np.random.default_rng(seed))

        def producer():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        break
                    batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    if seeds is None:
                        batch_seeds = rng.integers(0, 2 ** 31, size=len(batch_idx))
                    else:
                        batch_seeds = seeds[b * self.batch_size:(b + 1) * self.batch_size]
                    t0 = time.monotonic()
                    futs = [pool.submit(fetch_one, i, s)
                            for i, s in zip(batch_idx, batch_seeds)]
                    batch = collate([f.result() for f in futs])
                    self.stats.decode_s += time.monotonic() - t0
                    n = len(batch_idx)
                    if self.pad_to_batch and n < self.batch_size:
                        # pad arrays by repeating the last sample; "mask"
                        # marks real entries for mask-aware eval metrics
                        pad = self.batch_size - n
                        for key, val in list(batch.items()):
                            if isinstance(val, np.ndarray):
                                batch[key] = np.concatenate(
                                    [val, np.repeat(val[-1:], pad, axis=0)])
                    if self.pad_to_batch:
                        mask = np.zeros(self.batch_size, np.float32)
                        mask[:n] = 1.0
                        batch["mask"] = mask
                    out_q.put(batch)
                out_q.put(None)
            except BaseException as exc:  # propagate to consumer
                out_q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.monotonic()
                item = out_q.get()
                self.stats.wait_s += time.monotonic() - t0
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                self.stats.batches += 1
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


def device_prefetch(iterator, size: int = 2, device=None,
                    device_keys=("image", "target", "nuclei", "mask")):
    """Yield the iterator's batches with the numpy arrays under
    ``device_keys`` as tensors on ``device`` (the card unless the caller
    asks for the CPU; without a card and without ``device`` it raises); the
    other fields (tile and slide names) stay as they are.

    On the card, each array is copied into pinned host memory and sent with
    ``non_blocking=True`` on a side stream, ``size`` batches ahead of the
    one being consumed. A batch is handed over only after the consumer's
    stream waits on the event recorded behind its copies, and each tensor
    is marked as used by that stream (``record_stream``), so the caching
    allocator keeps its memory until the consumer's work on it is done.
    On the CPU the arrays become tensors that share their memory."""
    import collections

    import torch

    from .._device import resolve_device

    device = resolve_device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        out = dict(batch)
        arrays = {k: out[k] for k in device_keys if isinstance(out.get(k), np.ndarray)}
        if side is None:
            out.update({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})
            return out, None
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in arrays.items()}
        with torch.cuda.stream(side):
            out.update({k: v.to(device, non_blocking=True) for k, v in pinned.items()})
            done = torch.cuda.Event()
            done.record(side)
        return out, (done, pinned)    # the pinned buffers live until the handover

    def hand_over(item):
        out, copy = item
        if copy is not None:
            done, pinned = copy
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for k in pinned:
                out[k].record_stream(consumer)
        return out

    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        item = buf.popleft()
        for batch in it:
            buf.append(put(batch))
            break
        yield hand_over(item)
