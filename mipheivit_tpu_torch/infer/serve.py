"""Micro-batching online inference server on PyTorch (counterpart of
``mipheivit_tpu/infer/serve.py``).

Concurrent single-tile HTTP requests are coalesced into fixed-shape device
batches, run through the generator's forward and fanned back out per
request. uint8 crosses the bus both ways: tiles upload as raw uint8, the H&E
affine runs on the device, the forward runs in bf16 on the card (f32 on the
CPU), and the reference's uint8 output codec runs on the device before the
fetch. The device worker is one thread; request assembly happens on the HTTP
handler threads.

Protocol (stdlib only, npy bodies):
  POST /v1/predict   body: .npy, uint8 [H,W,3] or [B,H,W,3] H&E tile(s), 1 <= B <= batch
                     resp: .npy, uint8 [H,W,C] (or [B,H,W,C]); header X-Markers
  GET  /healthz      {"status": "ok"} once the model is warmed up
  GET  /stats        rolling latency/occupancy counters (JSON)

Beside the JAX daemon, this copy fails the Futures of requests still queued
when the batcher stops (none is left unresolved), lets ``TileServer.stop``
run before ``start``, answers an empty batch with 400, and batches the
requests that queued behind a running forward together (the JAX batcher
takes one of them per batch once the first one's deadline has passed).
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device

log = logging.getLogger(__name__)

_SENTINEL = object()


class MicroBatcher:
    """Coalesce concurrent single-item requests into fixed-shape batches.

    ``fwd_np`` takes a numpy batch ``[batch_size, ...]`` and returns a numpy
    batch of the same leading dim. Submissions block the caller only through
    the returned Future; batching runs on one worker thread, which flushes
    when the batch is full or the oldest request has waited
    ``max_delay_ms``. After ``stop`` no submission is taken, and every
    Future already handed out resolves: with its result, or with the error
    that stopped it."""

    def __init__(self, fwd_np: Callable[[np.ndarray], np.ndarray],
                 batch_size: int, item_shape: tuple,
                 max_delay_ms: float = 5.0, in_dtype=np.uint8,
                 queue_depth: int = 256):
        self.fwd_np = fwd_np
        self.batch_size = int(batch_size)
        self.item_shape = tuple(item_shape)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.in_dtype = np.dtype(in_dtype)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._lock = threading.Lock()
        # held while a submission checks the stop flag and enqueues, so that
        # nothing lands behind the stop sentinel
        self._submit_lock = threading.Lock()
        self._stats = {"n_requests": 0, "n_batches": 0, "n_padded_rows": 0}
        self._lat_ms: list = []          # rolling window, last 1024
        self._stopped = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatch-worker")
        self._worker.start()

    def submit(self, item: np.ndarray) -> Future:
        item = np.asarray(item)
        if item.shape != self.item_shape or item.dtype != self.in_dtype:
            raise ValueError(
                f"expected {self.in_dtype} tile of shape {self.item_shape}, "
                f"got {item.dtype} {item.shape}")
        fut: Future = Future()
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("MicroBatcher is stopped")
            self._q.put((item, fut, time.perf_counter()))
        return fut

    def stop(self) -> None:
        with self._submit_lock:
            if self._stopped:
                return
            self._stopped = True
        self._q.put(_SENTINEL)
        self._worker.join(timeout=30)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            lat = sorted(self._lat_ms)
        out["occupancy"] = (
            out["n_requests"] /
            max(out["n_batches"] * self.batch_size, 1))
        if lat:
            out["latency_ms_p50"] = lat[len(lat) // 2]
            out["latency_ms_p95"] = lat[min(len(lat) - 1,
                                            int(len(lat) * 0.95))]
        return out

    # -- worker ----------------------------------------------------------
    def _collect(self):
        """Block for the first request, then fill up to batch_size until the
        first request's deadline expires. Requests already queued join the
        batch even past the deadline: after a long forward, the first
        request's deadline has passed while the rest wait behind it."""
        first = self._q.get()
        if first is _SENTINEL:
            return None
        batch = [first]
        deadline = first[2] + self.max_delay_s
        while len(batch) < self.batch_size:
            timeout = deadline - time.perf_counter()
            try:
                nxt = self._q.get(timeout=timeout) if timeout > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                self._q.put(_SENTINEL)  # re-raise for the outer loop
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                self._run_batch(batch)
        finally:
            self._fail_leftovers()

    def _run_batch(self, batch) -> None:
        n = len(batch)
        x = np.zeros((self.batch_size,) + self.item_shape, self.in_dtype)
        for i, (item, _, _) in enumerate(batch):
            x[i] = item
        try:
            y = self.fwd_np(x)
        except Exception as e:  # surface device failures per request
            log.exception("serving forward failed")
            for _, fut, _ in batch:
                if not fut.cancelled():
                    fut.set_exception(e)
            return
        t_done = time.perf_counter()
        with self._lock:
            self._stats["n_requests"] += n
            self._stats["n_batches"] += 1
            self._stats["n_padded_rows"] += self.batch_size - n
            for _, _, t0 in batch:
                self._lat_ms.append(1000.0 * (t_done - t0))
            del self._lat_ms[:-1024]
        for i, (_, fut, _) in enumerate(batch):
            if not fut.cancelled():
                fut.set_result(y[i])

    def _fail_leftovers(self) -> None:
        """Fail whatever is still queued once the worker exits."""
        while True:
            try:
                entry = self._q.get_nowait()
            except queue.Empty:
                return
            if entry is not _SENTINEL and not entry[1].cancelled():
                entry[1].set_exception(RuntimeError("MicroBatcher is stopped"))


def _to_uint8_rint(pred: torch.Tensor) -> torch.Tensor:
    """The serving codec of the JAX daemon: ``rint(clip((y + 0.9) / 1.8, 0,
    1) * 255)`` (round half to even), in f32 on the device."""
    y = torch.clamp((pred.float() + 0.9) / 1.8, 0.0, 1.0) * 255.0
    return torch.round(y).to(torch.uint8)


def build_serving_fn(model, normalizer, tile_size: int, batch_size: int,
                     device=None, warmup: bool = True,
                     mesh=None) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 -> uint8 forward for ``MicroBatcher``: the H&E affine
    ``(x - mean) / std`` of ``normalizer`` (three values each, in pixel
    units) and the serving codec run on ``device`` (default: the model's).
    The returned function enters ``torch.inference_mode`` and the device on
    the thread that calls it (the batcher's worker). With ``warmup`` one
    full batch runs before it is returned, so kernel builds and library
    set-up happen before ``/healthz`` answers. With ``mesh``
    (``parallel.make_data_mesh``) the batch is split over one replica of the
    model per device of the mesh (``batch_size`` must divide by its size;
    ``device`` is ignored) and the parts are gathered into one uint8
    answer."""
    if mesh is not None:
        from ..parallel.mesh import replicate

        if batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} does not split over {mesh.size} replicas")
        models, devices = replicate(model, mesh), list(mesh.devices)
    else:
        models = [model]
        devices = [next(model.parameters()).device if device is None else torch.device(device)]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    on_card = devices[0].type == "cuda"
    stats = [(torch.as_tensor(np.asarray(normalizer.mean, np.float32).reshape(-1), device=d),
              torch.as_tensor(np.asarray(normalizer.std, np.float32).reshape(-1), device=d))
             for d in devices]

    def fwd_np(x: np.ndarray) -> np.ndarray:
        with torch.cuda.device(devices[0]) if on_card else contextlib.nullcontext(), \
                torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x))
            # every replica's forward is queued before the first answer is read
            ys = [_to_uint8_rint(m((part.to(d).float() - mean) / std))
                  for m, d, (mean, std), part in zip(models, devices, stats,
                                                     xt.chunk(len(models)))]
            return torch.cat([y.cpu() for y in ys]).numpy()

    if warmup:
        t0 = time.perf_counter()
        fwd_np(np.zeros((batch_size, tile_size, tile_size, 3), np.uint8))
        log.info("serving fn warmed up in %.1fs", time.perf_counter() - t0)
    return fwd_np


class TileServer:
    """HTTP front-end over a MicroBatcher. Construct with any numpy->numpy
    batch function (tests inject one), or use ``TileServer.from_checkpoint``
    for the generator of a checkpoint dir."""

    def __init__(self, fwd_np, tile_size: int, batch_size: int,
                 channel_names: Optional[Sequence[str]] = None,
                 max_delay_ms: float = 5.0, host: str = "127.0.0.1",
                 port: int = 0):
        self.tile_size = int(tile_size)
        self.channel_names = list(channel_names or [])
        self.batcher = MicroBatcher(
            fwd_np, batch_size,
            item_shape=(self.tile_size, self.tile_size, 3),
            max_delay_ms=max_delay_ms)
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="tile-server")

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, tile_size: int = 256,
                        batch_size: int = 32, max_delay_ms: float = 5.0,
                        host: str = "0.0.0.0", port: int = 8000,
                        dtype: Optional[str] = None, device=None,
                        mesh=None) -> "TileServer":
        """The generator of ``checkpoint_dir`` (its ``config.yaml`` beside
        the weights) at ``tile_size``, LoRA merged, warmed up and served.
        ``device`` defaults to the card and raises without one; ``dtype``
        (a torch dtype name) defaults to bfloat16 on the card and float32 on
        the CPU. With ``mesh`` (``parallel.make_data_mesh``) the generator is
        loaded on its first device and replicated over the others, each
        taking its slice of every batch."""
        from ..config import load_yaml
        from .tiles import load_serving_model

        device = resolve_device(device if mesh is None else mesh.devices[0])
        cfg = load_yaml(f"{checkpoint_dir}/config.yaml")
        names = list(cfg.data.targ_channel_names)
        model, he_norm = load_serving_model(
            cfg, checkpoint_dir, (tile_size, tile_size), len(names), device,
            dtype=None if dtype is None else getattr(torch, dtype))
        fwd_np = build_serving_fn(model, he_norm, tile_size, batch_size, device, mesh=mesh)
        return cls(fwd_np, tile_size, batch_size, channel_names=names,
                   max_delay_ms=max_delay_ms, host=host, port=port)

    def start(self) -> None:
        self._thread.start()
        log.info("serving on http://%s:%d (tile %d, batch %d)",
                 self.host, self.port, self.tile_size,
                 self.batcher.batch_size)

    def stop(self) -> None:
        if self._thread.is_alive():
            # shutdown waits for serve_forever, which runs only once started
            self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.stop()

    def serve_forever(self) -> None:
        self.start()
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()

    # -- HTTP ------------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj: dict):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._send_json(200, server.batcher.stats())
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/predict":
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    arr = np.load(io.BytesIO(self.rfile.read(n)),
                                  allow_pickle=False)
                except Exception as e:
                    self._send_json(400, {"error": f"bad npy body: {e}"})
                    return
                squeeze = arr.ndim == 3
                if squeeze:
                    arr = arr[None]
                ts = server.tile_size
                if (arr.ndim != 4 or arr.shape[1:] != (ts, ts, 3)
                        or arr.dtype != np.uint8
                        or not 1 <= arr.shape[0] <= server.batcher.batch_size):
                    self._send_json(400, {
                        "error": "expected uint8 [H,W,3] or [B,H,W,3] with "
                                 f"H=W={ts}, 1<=B<={server.batcher.batch_size}, "
                                 f"got {arr.dtype} {arr.shape}"})
                    return
                try:
                    futs = [server.batcher.submit(t) for t in arr]
                    preds = np.stack([f.result(timeout=120) for f in futs])
                except Exception as e:
                    self._send_json(503, {"error": str(e)})
                    return
                buf = io.BytesIO()
                np.save(buf, preds[0] if squeeze else preds)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npy")
                if server.channel_names:
                    self.send_header("X-Markers",
                                     ",".join(server.channel_names))
                body = buf.getvalue()
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler
