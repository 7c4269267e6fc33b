"""Overlap-averaged flow-field WSI segmentation, Cellpose-style (the port's
copy of ``preprocessings/nuclei_segmentation/flow_wsi.py``).

Reference: preprocessings/nuclei_segmentation/nuclei_dapi_wsi_cellpose/
cellpose_wsi_inference.py:161-249. Tile seams are healed by averaging the
flow fields, not the masks: overlapping tiles accumulate the 2-channel flow
(dp), the cell probability and a coverage count in disk-backed spills;
masks are then computed per chunk from the averaged fields with a halo,
keeping the instances the chunk's interior owns.

The spills are float16 / uint8 ``np.memmap``s (the reference's HDF5). The
backend is pluggable: ``cellpose_torch_flow_factory`` runs the port's CPnet
on the card, ``cellpose_flow_factory`` adapts the cellpose package, and
``flow_dynamics.reference_dynamics_factory`` needs no network.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from .wsi_nuclei_inference import (_read_scaled, _virtual_size, merge_owned_instances,
                                   sequential_relabel)


def flow_segment_wsi(reader, flow_fn, compute_masks_fn, tile_size: int = 2048,
                     overlap: int = 128, dapi_channel: int = 0, scratch_dir: str = None,
                     target_mpp: float = None, min_cellprob_sum: float = 10.0) -> np.ndarray:
    """Two-pass flow segmentation.

    ``flow_fn(tile_hw) -> (dp [2,h,w], cellprob [h,w])``;
    ``compute_masks_fn(dp, cellprob) -> labels [h,w]``. Returns the
    sequentially relabelled int32 plane (an ``np.memmap`` in
    ``scratch_dir``; ``cleanup_flow_scratch`` removes it)."""
    scale, vw, vh = _virtual_size(reader, target_mpp)
    scratch = Path(scratch_dir or tempfile.mkdtemp(prefix="flowseg_"))
    scratch.mkdir(parents=True, exist_ok=True)
    dp = np.memmap(scratch / "dp.f16", np.float16, "w+", shape=(2, vh, vw))
    prob = np.memmap(scratch / "prob.f16", np.float16, "w+", shape=(vh, vw))
    count = np.memmap(scratch / "count.u8", np.uint8, "w+", shape=(vh, vw))

    # pass 1: accumulate the flows over the overlapping tile grid
    stride = tile_size - overlap
    for ty in range(0, vh, stride):
        for tx in range(0, vw, stride):
            tw, th = min(tile_size, vw - tx), min(tile_size, vh - ty)
            tile = _read_scaled(reader, tx, ty, tw, th, scale)
            tile_dp, tile_prob = flow_fn(tile[..., dapi_channel])
            dp[:, ty:ty + th, tx:tx + tw] += tile_dp[:, :th, :tw].astype(np.float16)
            prob[ty:ty + th, tx:tx + tw] += tile_prob[:th, :tw].astype(np.float16)
            count[ty:ty + th, tx:tx + tw] += 1

    # pass 2: masks from the averaged fields, chunk by chunk with a halo
    labels = np.memmap(scratch / "labels.i32", np.int32, "w+", shape=(vh, vw))
    next_id = 0
    for ty in range(0, vh, tile_size):
        for tx in range(0, vw, tile_size):
            x0, y0 = max(tx - overlap, 0), max(ty - overlap, 0)
            x1, y1 = min(tx + tile_size + overlap, vw), min(ty + tile_size + overlap, vh)
            n = np.maximum(count[y0:y1, x0:x1].astype(np.float32), 1.0)
            chunk_prob = prob[y0:y1, x0:x1].astype(np.float32) / n
            # gate on the foreground-pixel count, like the reference's
            # np.sum(cellmask_chunk) < 10 (:230-231)
            if float((chunk_prob > 0).sum()) < min_cellprob_sum:
                continue
            chunk_dp = dp[:, y0:y1, x0:x1].astype(np.float32) / n
            tile_labels = np.asarray(compute_masks_fn(chunk_dp, chunk_prob), np.int32)
            next_id = merge_owned_instances(labels, tile_labels, tx, ty, x0, y0, x1, y1,
                                            tile_size, next_id, vh, vw)

    sequential_relabel(labels, next_id)
    for name in ("dp.f16", "prob.f16", "count.u8"):
        (scratch / name).unlink(missing_ok=True)
    # the caller holds a memmap of labels.i32: the directory stays until
    # cleanup_flow_scratch()
    labels.cleanup_dir = str(scratch)  # type: ignore[attr-defined]
    return labels


def cleanup_flow_scratch(labels) -> None:
    path = getattr(labels, "cleanup_dir", None)
    del labels
    if path:
        shutil.rmtree(path, ignore_errors=True)


def cellpose_torch_flow_factory(ckpt_path: str = None, model=None, x01: float = 0.0,
                                x99: float = 0.65, tile: int = 224, batch_size: int = 64,
                                device=None, stats: dict = None):
    """The port's Cellpose backend: the counterpart of
    ``cellpose_jax_flow_factory``, with the reference's eval semantics
    (cellpose_wsi_inference.py:132-135, 187-218): DAPI/255 normalised by
    the fixed (x01, x99) window, the image resized by ``diam_mean /
    diam_labels`` before the network (``cv2.resize``, linear) and the flows
    resized back, and ``niter = round(200 / rescale)`` integration steps.
    The CPnet (``model``, or ``ckpt_path`` loaded on ``device``: the card
    unless the caller asks for the CPU) runs in fixed-shape tile batches.

    ``stats``, when given, accumulates ``flow_s`` (wall seconds in
    ``flow_fn``), ``net_s`` and ``tiles`` (``eval_flows``), ``masks_s``
    (in ``compute_masks_fn``) and ``masks`` (its calls)."""
    from ...models.cellpose_net import eval_flows, load_cellpose_checkpoint
    from .flow_dynamics import compute_masks

    if model is None:
        if not ckpt_path:
            raise ValueError("cellpose_torch_flow_factory needs ckpt_path or model")
        model = load_cellpose_checkpoint(ckpt_path, device=device)
    rescale = model.rescale
    niter = int(round(200.0 / max(rescale, 1e-6)))
    stats = {} if stats is None else stats

    def flow_fn(dapi):
        import cv2

        t0 = time.perf_counter()
        x = dapi.astype(np.float32) / 255.0
        x = (x - x01) / max(x99 - x01, 1e-6)
        h, w = x.shape[:2]
        if rescale != 1.0:
            x = cv2.resize(x, (max(int(round(w * rescale)), 1), max(int(round(h * rescale)), 1)),
                           interpolation=cv2.INTER_LINEAR)
        dp, prob = eval_flows(model, x, tile=tile, batch_size=batch_size, stats=stats)
        if rescale != 1.0:
            dp = np.stack([cv2.resize(dp[c], (w, h), interpolation=cv2.INTER_LINEAR)
                           for c in range(2)])
            prob = cv2.resize(prob, (w, h), interpolation=cv2.INTER_LINEAR)
        stats["flow_s"] = stats.get("flow_s", 0.0) + time.perf_counter() - t0
        return dp.astype(np.float32), prob.astype(np.float32)

    def compute_masks_fn(dp, cellprob):
        t0 = time.perf_counter()
        out = compute_masks(dp, cellprob, cellprob_threshold=0.0, n_iter=niter)
        stats["masks_s"] = stats.get("masks_s", 0.0) + time.perf_counter() - t0
        stats["masks"] = stats.get("masks", 0) + 1
        return out

    return flow_fn, compute_masks_fn


def cellpose_flow_factory(pretrained_model: str = None, x01: float = 0.0, x99: float = 0.65):
    """The cellpose package's model (reference :135-209): ``flow_fn`` runs
    ``model.eval(compute_masks=False)`` on the normalised DAPI tile;
    ``compute_masks_fn`` follows the averaged flows."""
    from cellpose import dynamics, models  # optional dependency

    if pretrained_model:
        model = models.CellposeModel(pretrained_model=pretrained_model)
    else:
        model = models.Cellpose(model_type="nuclei")

    def normalize99(x):
        lo, hi = np.quantile(x, x01), np.quantile(x, x99)
        return np.clip((x - lo) / max(hi - lo, 1e-6), 0, 1)

    def flow_fn(dapi):
        x = normalize99(dapi.astype(np.float32) / 255.0)[..., None]
        _, flows, _ = model.eval([x], channels=[0, 0],
                                 diameter=getattr(model, "diam_labels", None),
                                 normalize=False, compute_masks=False)
        return np.squeeze(flows[0][1]), np.squeeze(flows[0][2])

    def compute_masks_fn(dp, cellprob):
        return dynamics.compute_masks(dp, cellprob, cellprob_threshold=0.0)[0]

    return flow_fn, compute_masks_fn
