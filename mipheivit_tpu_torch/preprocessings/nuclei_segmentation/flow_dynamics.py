"""Cellpose flow dynamics: labels -> flows and flows -> masks.

The port's copy of ``preprocessings/nuclei_segmentation/flow_dynamics.py``
(host numpy and scipy, as the original: the dynamics are not a network).
The reference delegates both directions to the cellpose package
(preprocessings/nuclei_segmentation/nuclei_dapi_wsi_cellpose/
cellpose_wsi_inference.py:156-249); this module implements the published
method (Stringer et al., Nat Methods 2021) directly:

* ``masks_to_flows(labels)``: the network's training target. Per cell,
  heat diffuses from the cell's median pixel inside the mask; the flow is
  the L2-normalised gradient of the heat map (pointing to the centre);
  cellprob is a +/- logit of the foreground mask.
* ``compute_masks(dp, cellprob)``: the inverse dynamics. Every foreground
  pixel is Euler-integrated along the bilinearly sampled flow; the pixels
  of one cell converge onto its centre; the converged points are clustered
  and the cluster ids propagated back to the pixels.

Fields made by ``masks_to_flows`` from a label plane have the structure of
network outputs (unit-norm centre-pointing gradients, logit cellprob), so
``reference_dynamics_factory`` drives ``flow_wsi`` without a network.
"""

from __future__ import annotations

import numpy as np


def masks_to_flows(labels: np.ndarray,
                   cellprob_logit: float = 5.0) -> tuple:
    """Ground-truth label plane -> (dp [2,H,W] float32, cellprob [H,W]).

    dp follows the CellPose convention: channel 0 = dy, channel 1 = dx,
    unit-norm inside cells, zero outside, pointing toward the cell's
    diffusion center. cellprob is ``+logit`` inside / ``-logit`` outside.
    """
    labels = np.asarray(labels)
    h, w = labels.shape
    dp = np.zeros((2, h, w), np.float32)
    for cid in np.unique(labels):
        if cid == 0:
            continue
        ys, xs = np.nonzero(labels == cid)
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        # 1px pad so gradients at the cell border see the zero exterior
        by0, bx0 = max(y0 - 1, 0), max(x0 - 1, 0)
        by1, bx1 = min(y1 + 1, h), min(x1 + 1, w)
        mask = labels[by0:by1, bx0:bx1] == cid
        my, mx = ys - by0, xs - bx0
        # median pixel snapped to the nearest in-mask pixel (concave cells)
        cy, cx = int(np.median(my)), int(np.median(mx))
        if not mask[cy, cx]:
            k = np.argmin((my - cy) ** 2 + (mx - cx) ** 2)
            cy, cx = my[k], mx[k]

        heat = np.zeros(mask.shape, np.float64)
        n_iter = 2 * int(mask.shape[0] + mask.shape[1])
        for _ in range(n_iter):
            heat[cy, cx] += 1.0
            # 4-neighbor diffusion confined to the mask
            acc = heat.copy()
            acc[1:] += heat[:-1]
            acc[:-1] += heat[1:]
            acc[:, 1:] += heat[:, :-1]
            acc[:, :-1] += heat[:, 1:]
            heat = np.where(mask, acc / 5.0, 0.0)
        # log-compress (cellpose does) so far-from-center gradients survive
        heat = np.log1p(heat)
        gy = np.zeros_like(heat)
        gx = np.zeros_like(heat)
        gy[1:-1] = heat[2:] - heat[:-2]
        gx[:, 1:-1] = heat[:, 2:] - heat[:, :-2]
        mag = np.sqrt(gy ** 2 + gx ** 2)
        ok = mask & (mag > 1e-12)
        gy = np.where(ok, gy / np.maximum(mag, 1e-12), 0.0)
        gx = np.where(ok, gx / np.maximum(mag, 1e-12), 0.0)
        sub = (slice(by0, by1), slice(bx0, bx1))
        dp[0][sub] = np.where(mask, gy, dp[0][sub])
        dp[1][sub] = np.where(mask, gx, dp[1][sub])
    cellprob = np.where(labels > 0, cellprob_logit,
                        -cellprob_logit).astype(np.float32)
    return dp, cellprob


def _bilinear(field: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    h, w = field.shape
    y = np.clip(y, 0.0, h - 1.0)
    x = np.clip(x, 0.0, w - 1.0)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy, fx = y - y0, x - x0
    return (field[y0, x0] * (1 - fy) * (1 - fx)
            + field[y1, x0] * fy * (1 - fx)
            + field[y0, x1] * (1 - fy) * fx
            + field[y1, x1] * fy * fx)


def compute_masks(dp: np.ndarray, cellprob: np.ndarray,
                  cellprob_threshold: float = 0.0, n_iter: int = 200,
                  step: float = 1.0, min_size: int = 15) -> np.ndarray:
    """Follow the flows, cluster the converged points -> int32 labels.

    Mirrors cellpose ``dynamics.compute_masks``: every pixel with
    cellprob above threshold is advected along the bilinearly-sampled
    flow; after ``n_iter`` steps the pixels of one cell sit in a tight
    cluster at its center, which is identified as a connected component
    of occupied (1px-dilated) landing cells; masks under ``min_size``
    pixels are dropped.
    """
    from scipy import ndimage

    fg = cellprob > cellprob_threshold
    h, w = fg.shape
    ys, xs = np.nonzero(fg)
    if ys.size == 0:
        return np.zeros((h, w), np.int32)
    py = ys.astype(np.float32)
    px = xs.astype(np.float32)
    for _ in range(n_iter):
        vy = _bilinear(dp[0], py, px)
        vx = _bilinear(dp[1], py, px)
        py = np.clip(py + step * vy, 0.0, h - 1.0)
        px = np.clip(px + step * vx, 0.0, w - 1.0)

    landing = np.zeros((h, w), bool)
    iy = np.rint(py).astype(np.int64)
    ix = np.rint(px).astype(np.int64)
    landing[iy, ix] = True
    # 1px dilation joins the +/-1-pixel oscillation ring around a center
    landing = ndimage.binary_dilation(landing, np.ones((3, 3), bool))
    clusters, _ = ndimage.label(landing)

    labels = np.zeros((h, w), np.int32)
    labels[ys, xs] = clusters[iy, ix]
    # drop sub-minimum instances, then densify ids
    ids, counts = np.unique(labels[labels > 0], return_counts=True)
    small = ids[counts < min_size]
    if small.size:
        labels[np.isin(labels, small)] = 0
    ids = np.unique(labels[labels > 0])
    remap = np.zeros(labels.max() + 1, np.int32)
    remap[ids] = np.arange(1, ids.size + 1, dtype=np.int32)
    return remap[labels]


def reference_dynamics_factory(gt_labels_fn,
                               cellprob_threshold: float = 0.0):
    """flow_wsi backend built from first-party dynamics: ``flow_fn``
    produces model-faithful fields via ``masks_to_flows`` over a
    ground-truth-label provider (``gt_labels_fn(tile_hw) -> labels``;
    in tests, crops of a synthetic plane; in production, any upstream
    segmentation whose seams need flow-averaged healing), and
    ``compute_masks_fn`` is the real flow-following inverse."""
    def flow_fn(dapi_tile):
        return masks_to_flows(gt_labels_fn(dapi_tile))

    def compute_masks_fn(dp, cellprob):
        return compute_masks(dp, cellprob,
                             cellprob_threshold=cellprob_threshold)

    return flow_fn, compute_masks_fn
