"""Nucleus instance-segmentation backends (the port's copy of
``preprocessings/nuclei_segmentation/backends.py``).

The reference runs Cellpose on the DAPI channel (reference:
preprocessings/nuclei_segmentation/nuclei_dapi_wsi_cellpose/
cellpose_wsi_inference.py). The backend is pluggable: the ``cellpose``
package when it is installed, ``torch`` (the port's CPnet on the card,
``models/cellpose_net.py``, with the flow dynamics of ``flow_dynamics``),
or a classical distance-transform watershed (cv2) with the same label-mask
contract. cv2 is imported inside the functions that use it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def classical_segment(dapi: np.ndarray, thresh_rel: float = 0.0,
                      min_distance: int = 5) -> np.ndarray:
    """Otsu + distance-transform watershed -> int32 instance labels."""
    import cv2

    img = dapi.astype(np.float32)
    lo, hi = img.min(), img.max()
    if hi <= lo:
        return np.zeros(dapi.shape, np.int32)
    u8 = ((img - lo) / (hi - lo) * 255).astype(np.uint8)
    u8 = cv2.GaussianBlur(u8, (5, 5), 1.5)
    _, binary = cv2.threshold(u8, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    binary = cv2.morphologyEx(binary, cv2.MORPH_OPEN, np.ones((3, 3), np.uint8))
    dist = cv2.distanceTransform(binary, cv2.DIST_L2, 5)
    # seeds: local maxima via dilation comparison
    kernel = np.ones((2 * min_distance + 1,) * 2, np.uint8)
    local_max = (dist == cv2.dilate(dist, kernel)) & (dist > 1.0)
    n, markers = cv2.connectedComponents(local_max.astype(np.uint8))
    if n <= 1:
        n, markers = cv2.connectedComponents((binary > 0).astype(np.uint8))
        return markers.astype(np.int32)
    # cv2.watershed's markers: known background 1, seeds 2.., unknown (to
    # be flooded) 0; the foreground around the seeds stays unknown
    markers = markers + 1
    markers[local_max == 0] = 0
    markers[binary == 0] = 1
    color = cv2.cvtColor(u8, cv2.COLOR_GRAY2BGR)
    ws = cv2.watershed(color, markers.astype(np.int32))
    labels = np.where(ws > 1, ws - 1, 0).astype(np.int32)
    labels[binary == 0] = 0
    return labels


def cellpose_segment_factory(model_type: str = "nuclei",
                             diameter: Optional[float] = None) -> Callable:
    """The ``cellpose`` package's own model (an optional dependency)."""
    from cellpose import models  # noqa: F401 (optional dependency)

    model = models.Cellpose(model_type=model_type)

    def segment(dapi: np.ndarray) -> np.ndarray:
        masks, *_ = model.eval(dapi, diameter=diameter, channels=[0, 0])
        return masks.astype(np.int32)

    return segment


def torch_segment_factory(cellpose_ckpt: str, device=None, **flow_kw) -> Callable:
    """Per-tile instance segmentation with the port's CPnet: network flows on
    ``device`` (the card unless the caller asks for the CPU), then the flow
    dynamics on the host (reference pipeline: cellpose_wsi_inference.py:
    187-233). The counterpart of ``jax_segment_factory``."""
    from .flow_wsi import cellpose_torch_flow_factory

    flow_fn, masks_fn = cellpose_torch_flow_factory(cellpose_ckpt, device=device, **flow_kw)

    def segment(dapi: np.ndarray) -> np.ndarray:
        dp, prob = flow_fn(dapi)
        return np.asarray(masks_fn(dp, prob), np.int32)

    return segment


def get_backend(name: str = "auto", cellpose_ckpt: Optional[str] = None,
                device=None) -> Callable:
    """``"torch"``: the port's CPnet (needs ``cellpose_ckpt``);
    ``"cellpose"``: the cellpose package; ``"auto"``: cellpose when it is
    installed, else the classical watershed; ``"classical"``: the
    watershed."""
    if name == "torch":
        return torch_segment_factory(cellpose_ckpt, device=device)
    if name in ("auto", "cellpose"):
        try:
            return cellpose_segment_factory()
        except ImportError:
            if name == "cellpose":
                raise
    return classical_segment


def expand_labels(labels: np.ndarray, distance: float) -> np.ndarray:
    """Watershed nucleus expansion (reference: cellpose_wsi_inference.py
    :258-274): background pixels within ``distance`` of a nucleus join the
    nearest nucleus (skimage.segmentation.expand_labels through
    cv2.distanceTransformWithLabels)."""
    if distance <= 0:
        return labels
    import cv2

    background = (labels == 0).astype(np.uint8)
    dist, nearest = cv2.distanceTransformWithLabels(
        background, cv2.DIST_L2, 5, labelType=cv2.DIST_LABEL_PIXEL)
    # nearest: the id of the closest zero pixel of `background` (a labelled
    # pixel); the ids number those pixels in scan order
    fg_idx = np.flatnonzero(labels.reshape(-1) > 0)
    lut = np.zeros(labels.size + 1, labels.dtype)
    ids_at_fg = nearest.reshape(-1)[fg_idx]
    lut[ids_at_fg] = labels.reshape(-1)[fg_idx]
    expanded = lut[nearest.reshape(-1)].reshape(labels.shape)
    return np.where((dist <= distance) & (labels == 0), expanded, labels)


def find_boundaries(labels: np.ndarray) -> np.ndarray:
    """Instance boundary mask (skimage.find_boundaries, 'outer'-like)."""
    up = np.zeros_like(labels)
    up[1:] = labels[:-1]
    left = np.zeros_like(labels)
    left[:, 1:] = labels[:, :-1]
    boundary = (labels != up) | (labels != left)
    return (boundary & (labels > 0)).astype(np.int32)
