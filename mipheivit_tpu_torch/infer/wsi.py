"""Sliding-window whole-slide inference with overlap stitching (PyTorch).

Counterpart of ``mipheivit_tpu/infer/wsi.py::wsi_inference`` on one card.
The slide is cut into overlapping windows in raster order; each batch of
uint8 windows goes to the device, where H&E normalization, the generator
forward, the output codec and the blend window run; predictions come back
as f16 (or uint8) and are feathered into a bounded-memory rolling
accumulator whose finished rows stream into a pyramidal OME-TIFF writer or
an in-memory ``[C, H, W]`` uint8 array.

The host side is a four-stage pipeline:

  reader threads -> batch queue -> dispatch on the CUDA stream -> fetch
  threads -> stitcher thread

Reader threads fill a bounded queue of uint8 batches in pinned memory. The
dispatching thread copies each batch to the card (``non_blocking``),
enqueues its forward and a device-to-host copy into a pinned buffer fenced
by a CUDA event, and keeps up to ``dispatch_depth`` of them queued before
handing the oldest to a fetch thread. ``fetch_workers`` fetches overlap.
The stitcher thread consumes them in dispatch order (the accumulator needs
raster order), so stitching runs beside dispatch, not inline with it.

The slide IO (``SlideReader``, ``PyramidWriter``, ``get_locs_otsu``) is
the JAX package's jax-free ``mipheivit_tpu.slideio``, imported only when a
path or ``tissue_only`` asks for it; ``ArraySlide`` and an array sink need
none of it.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from .stitch import BandSink, RollingAccumulator, blend_window

log = logging.getLogger(__name__)


class ArraySlide:
    """An in-memory ``[H, W, 3]`` uint8 slide with the part of
    ``SlideReader``'s interface that a full window grid reads (one level, no
    thumbnail: use ``tissue_only=False``). ``read_region`` zero-pads past the
    slide's edge, as ``SlideReader`` does."""

    def __init__(self, image: np.ndarray, mpp: Optional[float] = None):
        if image.ndim != 3 or image.dtype != np.uint8:
            raise ValueError(f"ArraySlide takes an [H, W, C] uint8 array, got "
                             f"{image.shape} {image.dtype}")
        self.image = image
        self.mpp = mpp
        h, w = image.shape[:2]
        self.level_dimensions = [(w, h)]

    def read_region(self, location, level: int, size) -> np.ndarray:
        (x, y), (w, h) = location, size
        out = np.zeros((h, w, self.image.shape[2]), np.uint8)
        part = self.image[y:y + h, x:x + w]
        out[:part.shape[0], :part.shape[1]] = part
        return out


def _window_locs(reader, level: int, tile_size: int, overlap: int,
                 tissue_only: bool, mask_thresh: float) -> np.ndarray:
    """Top-left (x, y) of every window, in raster order."""
    w, h = reader.level_dimensions[level]
    if tissue_only:
        from mipheivit_tpu.slideio import get_locs_otsu

        thumb = reader.get_thumbnail((2048, 2048))
        ds = reader.level_downsample(level)
        locs, _ = get_locs_otsu(thumb, reader.level_dimensions[0], tile_size * ds,
                                tile_overlap=overlap * ds, mask_thresh=mask_thresh)
        locs = (locs / ds).astype(np.int64)
    else:
        stride = tile_size - overlap
        xs = np.arange(0, max(w - overlap, 1), stride)
        ys = np.arange(0, max(h - overlap, 1), stride)
        locs = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    # raster order is required by the rolling accumulator
    return locs[np.lexsort((locs[:, 0], locs[:, 1]))]


def _window_forward(model, x_uint8: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                    window: Optional[torch.Tensor]) -> torch.Tensor:
    """The device half of one batch: H&E normalization, the forward, and
    ``clip((y + 0.9) / 1.8, 0, 1) * 255``; then ``window`` multiplied in and
    f16 out, or (``window`` None) ``rint`` to uint8 out. ``x_uint8`` is
    ``[B, T, T, 3]``, ``window`` ``[1, T, T, 1]`` f32."""
    y = model((x_uint8.float() - mean) / std)
    y = torch.clamp((y.float() + 0.9) / 1.8, 0.0, 1.0) * 255.0
    if window is None:
        return torch.round(y).to(torch.uint8)
    return (y * window).to(torch.float16)


def wsi_inference(
    model,
    slide,
    out,
    channel_names: Sequence[str],
    he_normalizer,
    tile_size: int = 256,
    overlap: int = 64,
    batch_size: int = 16,
    level: int = 0,
    tissue_only: bool = True,
    mask_thresh: float = 0.0,
    n_pyramid_levels: int = 4,
    memmap_path: Optional[str] = None,
    read_workers: int = 8,
    queue_depth: int = 4,
    dispatch_depth: int = 2,
    fetch_workers: int = 4,
    stats: Optional[dict] = None,
    fetch_uint8: bool = False,
):
    """Stitched sliding-window inference over one slide.

    ``model`` is the generator; it runs on the device of its weights, and
    the JAX function's ``variables`` live in it. ``slide`` is a path (opened
    with ``SlideReader``, closed at the end) or an object with its interface
    (``level_dimensions``, ``read_region`` and ``mpp``; with
    ``tissue_only``, ``level_downsample`` and ``get_thumbnail`` too), e.g.
    ``ArraySlide``. ``out`` is an output path (pyramidal OME-TIFF through
    ``PyramidWriter``, or through a ``memmap_path`` mosaic and
    ``write_pyramid``) or a ``[C, H, W]`` uint8 array that receives the
    stitched prediction; it is returned.
    ``he_normalizer`` carries the H&E ``mean`` and ``std`` (pixel units),
    applied on the device. ``fetch_uint8`` rounds the unwindowed prediction
    to uint8 on the device and applies the window on the host (half the
    fetch of f16, within half an output step). ``stats`` receives the
    pipeline's timers, with the keys of the JAX function's."""
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    stride = tile_size - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} must be below tile_size {tile_size}")
    mean = getattr(he_normalizer, "mean", None)
    if getattr(he_normalizer, "mode", "he") != "he" or mean is None:
        raise ValueError("wsi_inference normalizes on the device: it needs an H&E "
                         "normalizer with mean and std")

    own_reader = isinstance(slide, (str, os.PathLike))
    if own_reader:
        from mipheivit_tpu.slideio import SlideReader

        reader = SlideReader(str(slide), mode="RGB")
    else:
        reader = slide
    w, h = reader.level_dimensions[level]
    mpp = reader.mpp
    n_ch = len(channel_names)
    locs = _window_locs(reader, level, tile_size, overlap, tissue_only, mask_thresh)
    log.info("WSI %s: %dx%d, %d windows", slide if own_reader else "array", w, h, len(locs))

    writer = xml = None
    if isinstance(out, np.ndarray):
        if out.shape != (n_ch, h, w) or out.dtype != np.uint8:
            raise ValueError(f"array sink must be [{n_ch}, {h}, {w}] uint8, got "
                             f"{out.shape} {out.dtype}")
        sink = out
    else:
        from mipheivit_tpu.slideio import PyramidWriter, build_ome_xml

        xml = build_ome_xml(w, h, channel_names, "uint8", physical_size_um=mpp)
        if memmap_path:
            sink = np.memmap(memmap_path, dtype=np.uint8, mode="w+", shape=(n_ch, h, w))
        else:
            writer = PyramidWriter(
                str(out), width=w, height=h, n_channels=n_ch, dtype=np.uint8,
                n_levels=n_pyramid_levels, tile_size=min(512, tile_size),
                mpp=mpp or 0.0, ome_xml=xml)
            sink = BandSink(writer)
    rolling = RollingAccumulator(sink, tile_size, stride)
    window = blend_window(tile_size, overlap)

    norm_mean = torch.as_tensor(np.asarray(mean, np.float32).reshape(-1), device=device)
    norm_std = torch.as_tensor(np.asarray(he_normalizer.std, np.float32).reshape(-1),
                               device=device)
    win_dev = None if fetch_uint8 else torch.from_numpy(window).to(device)[None, :, :, None]

    # ---- stage 1: reader threads fill a bounded queue of ready batches ----
    batch_q: queue.Queue = queue.Queue(maxsize=queue_depth)
    stop = threading.Event()
    producer_err: list = []

    def _put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _read(loc):
        return reader.read_region((int(loc[0]), int(loc[1])), level, (tile_size, tile_size))

    def _producer():
        try:
            with ThreadPoolExecutor(read_workers) as pool:
                inflight: deque = deque()
                idx = 0
                for start in range(0, len(locs), batch_size):
                    n = min(batch_size, len(locs) - start)
                    # the ragged last batch is padded to the batch size
                    buf = torch.zeros((batch_size, tile_size, tile_size, 3), dtype=torch.uint8,
                                      pin_memory=cuda)
                    arr = buf.numpy()
                    for i in range(n):
                        while idx < len(locs) and len(inflight) < max(read_workers * 2, batch_size):
                            inflight.append(pool.submit(_read, locs[idx]))
                            idx += 1
                        arr[i] = inflight.popleft().result()
                    coords = [(int(x), int(y)) for x, y in locs[start:start + n]]
                    if not _put(batch_q, (buf, coords, n)):
                        return
        except BaseException as e:  # surface reader failures to the consumer
            producer_err.append(e)
        finally:
            _put(batch_q, None)

    # ---- stages 3-4: overlapped fetch -> ordered stitch on its own thread ----
    stitch_q: queue.Queue = queue.Queue(maxsize=max(1, fetch_workers))
    stitch_err: list = []
    timers = {"device_wait_s": 0.0, "stitch_s": 0.0, "t_first_drain": None,
              "tiles_drained": 0}

    def _fetch(event, host, n):
        if event is not None:
            event.synchronize()
        # widen at once: numpy f16 arithmetic is scalar-emulated and would
        # move the bottleneck into the accumulator
        return host.numpy()[:n].astype(np.float32)

    def _stitcher():
        while True:
            item = stitch_q.get()
            if item is None:
                return
            if stitch_err:
                continue  # keep draining so the dispatcher never blocks
            fut, coords, n = item
            try:
                t0 = time.perf_counter()
                preds = fut.result()
                t1 = time.perf_counter()
                if timers["t_first_drain"] is not None:
                    # the first batch absorbs warm-up: it is left out of the
                    # steady window that device_wait_s is read against
                    timers["device_wait_s"] += t1 - t0
                for pred, (tx, ty) in zip(preds, coords):
                    rolling.add(pred, tx, ty, window, pre_windowed=not fetch_uint8)
                timers["stitch_s"] += time.perf_counter() - t1
                if timers["t_first_drain"] is None:
                    timers["t_first_drain"] = time.perf_counter()
                timers["tiles_drained"] += n
            except BaseException as e:
                stitch_err.append(e)

    producer = threading.Thread(target=_producer, daemon=True, name="wsi-read-producer")
    stitcher = threading.Thread(target=_stitcher, daemon=True, name="wsi-stitcher")
    fetch_pool = ThreadPoolExecutor(max(1, fetch_workers), thread_name_prefix="wsi-fetch")
    producer.start()
    stitcher.start()

    # ---- stage 2: dispatch on the device's stream ----
    read_wait_s = 0.0
    n_batches = n_tiles_seen = 0
    pending: deque = deque()      # dispatched, fetch not yet started
    t_wall0 = time.perf_counter()

    def _start_fetch():
        event, host, coords, n = pending.popleft()
        stitch_q.put((fetch_pool.submit(_fetch, event, host, n), coords, n))

    try:
        try:
            with torch.inference_mode():
                while True:
                    t0 = time.perf_counter()
                    item = batch_q.get()
                    read_wait_s += time.perf_counter() - t0
                    if item is None or stitch_err:
                        break
                    buf, coords, n = item
                    y = _window_forward(model, buf.to(device, non_blocking=True),
                                        norm_mean, norm_std, win_dev)
                    event = None
                    if cuda:
                        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                        host.copy_(y, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record()
                    else:
                        host = y
                    pending.append((event, host, coords, n))
                    n_batches += 1
                    n_tiles_seen += n
                    if n_batches % 4 == 0:
                        log.info("WSI progress: %d/%d windows", n_tiles_seen, len(locs))
                    while len(pending) > dispatch_depth:
                        _start_fetch()
                while pending:
                    _start_fetch()
        finally:
            stop.set()
            stitch_q.put(None)
            stitcher.join()
            fetch_pool.shutdown()
            producer.join()
            if own_reader:
                reader.close()
        if producer_err or stitch_err:
            raise (producer_err or stitch_err)[0]
    except BaseException:
        if writer is not None:
            writer.abort()
        raise

    t_drained = time.perf_counter()
    rolling.finalize()
    finalize_s = time.perf_counter() - t_drained
    t_first = timers["t_first_drain"]
    if n_batches:
        log.info("WSI pipeline: %d batches, read-starvation %.1f ms/batch, "
                 "device-wait %.1f ms/batch (steady window)",
                 n_batches, 1000.0 * read_wait_s / n_batches,
                 1000.0 * timers["device_wait_s"] / max(n_batches - 1, 1))
    if stats is not None:
        stats.update({
            "n_tiles": int(n_tiles_seen), "n_batches": int(n_batches),
            "batch_size": int(batch_size),
            "wall_s": t_drained - t_wall0,
            # steady state: everything after the first drained batch
            "steady_s": t_drained - t_first if t_first is not None else 0.0,
            "steady_tiles": int(max(timers["tiles_drained"] - batch_size, 0)),
            "steady_batches": int(max(n_batches - 1, 0)),
            "read_wait_s": read_wait_s, "device_wait_s": timers["device_wait_s"],
            "stitch_s": timers["stitch_s"], "finalize_s": finalize_s,
        })
    if writer is not None:
        writer.close()
    elif xml is not None:
        from mipheivit_tpu.slideio import write_pyramid

        write_pyramid(str(out), sink, n_levels=n_pyramid_levels,
                      tile_size=min(512, tile_size), mpp=mpp or 0.0, ome_xml=xml)
    log.info("wrote the stitched prediction to %s", "the array" if xml is None else out)
    return out
