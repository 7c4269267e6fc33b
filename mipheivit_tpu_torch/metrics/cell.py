"""Single-cell metrics: per-nucleus pooling -> AUC / F1 via logreg gating.

The port's counterpart of ``mipheivit_tpu/metrics/cell.py`` (reference:
``CellMetrics``, src/metrics.py:11-253): per-slide accumulation of
per-nucleus marker sums and pixel counts, quantised as the reference does
(sums ``* 255`` to uint32, counts to uint16), a per-cell mean table across
tiles (``area > min_area``), a left merge with the GMM-gated ground-truth
``{marker}_pos`` columns of each slide's nuclei CSV, then a one-vs-rest
logistic regression fitted on the epoch's cells; reports the mean and
per-marker AUC, AUC of the logreg, balanced accuracy and F1. Hoechst and
Dapi are excluded (src/metrics.py:14).

The pooling runs on the device the predictions live on
(``ops.segment_pool.nucleus_pool``, no host sync); only the compact
``(ids, sums, counts)`` of a batch, already quantised, cross to the host,
in one copy. The tables are ``data.table.Table`` and the statistics
``metrics._gating`` (numpy): neither pandas nor scikit-learn is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.table import Table
from ..ops.segment_pool import nucleus_pool
from . import _gating

EXCLUDED_MARKERS = ("Hoechst", "Dapi")
METRIC_KEYS = ("auc", "auc_logreg", "balanced_acc", "f1")


@dataclasses.dataclass
class LogRegHead:
    """The linear gating head with the scaler folded into its weights
    (reference: src/metrics.py:232-248)."""

    weight: np.ndarray  # [n_markers, n_markers]
    bias: np.ndarray    # [n_markers]

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        logits = x @ self.weight.T + self.bias
        return 1.0 / (1.0 + np.exp(-logits))

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"weight": self.weight, "bias": self.bias}


def _matrix(table: Table, columns: Sequence[str]) -> np.ndarray:
    return np.stack([table[c] for c in columns], axis=1) if len(table) else \
        np.zeros((0, len(columns)))


class CellMetrics:
    def __init__(self, slide_dataframe: Table, marker_names: Sequence[str], min_area: int = 20,
                 capacity: int = 2048):
        filtered = [(i, n) for i, n in enumerate(marker_names) if n not in EXCLUDED_MARKERS]
        self.marker_names = [n for _, n in filtered]
        self.marker_idxs = [i for i, _ in filtered]
        self.marker_cols = [f"{n}_pos" for n in self.marker_names]
        self.marker_pred_cols = [f"{n}_pred" for n in self.marker_names]
        self.min_area = min_area
        self.capacity = capacity
        self.slide_names = list(slide_dataframe["in_slide_name"].tolist())
        self.csv_path_dict = dict(zip(self.slide_names,
                                      slide_dataframe["nuclei_csv_path"].tolist()))
        self._idx: Dict[torch.device, torch.Tensor] = {}
        self.reset()

    def reset(self):
        self._acc: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {
            name: [] for name in self.slide_names}

    # -- pooling on the device, accumulation on the host -------------------
    def pool(self, preds: torch.Tensor, nuclei_masks: torch.Tensor):
        """preds ``[B, H, W, C]`` in (-0.9, 0.9) (any float dtype), nuclei
        ``[B, H, W]`` integer ids, on one device. Returns ``(ids, sums,
        counts)`` there, the sums of ``(clip(p, -0.9, 0.9) + 0.9) / 1.8`` in
        f32."""
        idx = self._idx.get(preds.device)
        if idx is None:
            idx = self._idx[preds.device] = torch.tensor(self.marker_idxs, device=preds.device)
        p = torch.clamp(preds.index_select(-1, idx).float(), -0.9, 0.9)
        p = (p + 0.9) / 1.8
        return nucleus_pool(p, nuclei_masks.to(torch.int32), self.capacity)

    def update(self, preds, nuclei_masks, slide_names: Sequence[str]):
        """Pool one batch and keep its valid nuclei per slide. One copy to
        the host: ids, the quantised sums and the counts, packed in int32."""
        preds = torch.as_tensor(preds)
        ids, sums, counts = self.pool(preds, torch.as_tensor(nuclei_masks, device=preds.device))
        # quantisation parity (reference: src/metrics.py:68-70): truncation
        # of the non-negative f32 sums * 255
        packed = torch.cat([ids[..., None], (sums * 255.0).to(torch.int32),
                            counts[..., None].to(torch.int32)], dim=-1).cpu().numpy()
        ids, sums_q, counts = packed[..., 0], packed[..., 1:-1], packed[..., -1]
        for b, slide_name in enumerate(slide_names):
            valid = (counts[b] > 0) & (ids[b] > 0)
            if not valid.any():
                continue
            self._acc[slide_name].append((ids[b][valid].astype(np.uint32),
                                          sums_q[b][valid].astype(np.uint32),
                                          counts[b][valid].astype(np.uint16)))

    # -- host-side tables ---------------------------------------------------
    def get_dataframe_cell_pred(self) -> Table:
        """One row per cell with area > ``min_area``: ``cell_id``, the
        per-marker means ``{marker}_pred``, ``area`` and ``slide_name``;
        slides in order, cells by id (``groupby("cell_id").sum()``)."""
        frames = []
        for slide_name in self.slide_names:
            chunks = self._acc[slide_name]
            if not chunks:
                continue
            sums = np.concatenate([c[1] for c in chunks]).astype(np.float64)
            table = Table({"cell_id": np.concatenate([c[0] for c in chunks]).astype(np.uint64),
                           **{col: sums[:, j] for j, col in enumerate(self.marker_pred_cols)},
                           "area": np.concatenate([c[2] for c in chunks]).astype(np.int64)})
            table = table.groupby_sum("cell_id", self.marker_pred_cols + ["area"])
            table = table.filter(table["area"] > self.min_area)
            area = table["area"]
            for col in self.marker_pred_cols:
                # f32 sums over an int64 area: float64, as in pandas
                table = table.replace(col, table[col].astype(np.float32) / area)
            names = np.empty(len(table), object)
            names[:] = slide_name
            frames.append(table.replace("slide_name", names))
        if not frames:
            return Table({"cell_id": np.zeros(0, np.uint64),
                          **{c: np.zeros(0) for c in self.marker_pred_cols},
                          "area": np.zeros(0, np.int64), "slide_name": np.zeros(0, object)})
        return Table.concat(frames)

    def get_dataframe_cell_target(self, slide_names=None) -> Table:
        """``label`` and the ``{marker}_pos`` columns of each slide's nuclei
        CSV, with ``slide_name``."""
        frames = []
        for slide_name in (slide_names if slide_names is not None else self.slide_names):
            table = Table.read_csv(self.csv_path_dict[slide_name],
                                   usecols=["label"] + self.marker_cols)
            names = np.empty(len(table), object)
            names[:] = slide_name
            frames.append(table.replace("slide_name", names))
        if not frames:
            return Table({"label": np.zeros(0, np.int64),
                          **{c: np.zeros(0, bool) for c in self.marker_cols},
                          "slide_name": np.zeros(0, object)})
        return Table.concat(frames)

    def get_dataframe_cell_pred_target(self) -> Table:
        """The cell means left-merged with their slide's ground truth on
        (slide, cell id); cells missing from the CSV are dropped."""
        pred = self.get_dataframe_cell_pred()
        target = self.get_dataframe_cell_target(pred.unique("slide_name"))
        table = pred.merge(target, left_on=["slide_name", "cell_id"],
                           right_on=["slide_name", "label"], how="left")
        table = table.drop(["area"])
        label = table["label"]
        if label.dtype.kind == "f":
            table = table.filter(~np.isnan(label))
        for col in self.marker_cols:
            table = table.replace(col, table[col].astype(bool))
        return table

    # -- logreg gating -------------------------------------------------------
    def train_logistic_regression(self, train_dataframe: Table,
                                  test_dataframe: Optional[Table] = None,
                                  return_metrics: bool = True):
        """Fit the scaler and the one-vs-rest logistic regression on
        ``train_dataframe``; returns the head with the scaler folded in,
        and first, with ``return_metrics``, ``[(marker, AUC, balanced
        accuracy, F1)]`` on ``test_dataframe`` (else on the training
        cells)."""
        x_train = _matrix(train_dataframe, self.marker_pred_cols).astype(np.float64)
        y_train = _matrix(train_dataframe, self.marker_cols).astype(bool)
        means, stds = _gating.fit_scaler(x_train)
        model = _gating.fit_one_vs_rest((x_train - means) / stds, y_train)

        results = None
        if return_metrics:
            if test_dataframe is None:
                x_test, y_test = x_train, y_train
            else:
                x_test = _matrix(test_dataframe, self.marker_pred_cols).astype(np.float64)
                y_test = _matrix(test_dataframe, self.marker_cols).astype(bool)
            xs_test = (x_test - means) / stds
            proba, pred = model.predict_proba(xs_test), model.predict(xs_test)
            results = [(marker, _gating.roc_auc(y_test[:, idx], proba[:, idx]),
                        _gating.balanced_accuracy(y_test[:, idx], pred[:, idx]),
                        _gating.f1(y_test[:, idx], pred[:, idx]))
                       for idx, marker in enumerate(self.marker_cols)]

        # fold the scaler into a plain linear head (reference: :232-248); a
        # constant column keeps a zero row and a zero bias
        weights, bias = model.coef, model.intercept
        head = LogRegHead(
            weight=(weights / stds).astype(np.float32),
            bias=(bias - np.sum(weights * means / stds, axis=1)).astype(np.float32))
        if return_metrics:
            return results, head
        return head

    # -- the epoch's end -----------------------------------------------------
    def compute(self, logreg_head: Optional[LogRegHead] = None, return_dataframe: bool = False):
        """``{"auc", "auc_logreg", "balanced_acc", "f1"}`` (means over the
        markers), ``{marker}_pos_{key}`` per marker with both classes
        present, ``state_dict`` and ``logreg_head`` (fitted on these cells
        when none is given); clears the accumulators."""
        dataframe = self.get_dataframe_cell_pred_target()
        metrics: Dict = {key: 0.0 for key in METRIC_KEYS}
        if logreg_head is None:
            logreg_head = self.train_logistic_regression(dataframe, return_metrics=False)
        preds = _matrix(dataframe, self.marker_pred_cols)
        targets = _matrix(dataframe, self.marker_cols).astype(bool)
        probs = logreg_head.predict_proba(preds)
        hard = probs > 0.5

        for idx, marker_col in enumerate(self.marker_cols):
            t = targets[..., idx]
            if len(t) == 0 or len(np.unique(t)) == 1:
                continue
            values = {"auc": _gating.roc_auc(t, preds[..., idx]),
                      "auc_logreg": _gating.roc_auc(t, probs[..., idx]),
                      "balanced_acc": _gating.balanced_accuracy(t, hard[..., idx]),
                      "f1": _gating.f1(t, hard[..., idx])}
            for key, value in values.items():
                metrics[f"{marker_col}_{key}"] = value
                metrics[key] += value
        n = len(self.marker_names)
        for key in METRIC_KEYS:
            metrics[key] /= n
        metrics["state_dict"] = logreg_head.state_dict()
        metrics["logreg_head"] = logreg_head
        self.reset()
        if return_dataframe:
            return metrics, dataframe
        return metrics


def find_best_threshold(y_true, y_pred, low=0, high=10, tol=1e-3):
    """Ternary search for the balanced-accuracy-optimal threshold
    (reference: src/metrics.py:256-278)."""
    best_thresh, best_score = None, 0.0
    while (high - low) > tol:
        mid1 = low + (high - low) / 3
        mid2 = high - (high - low) / 3
        s1 = _gating.balanced_accuracy(y_true, y_pred > mid1)
        s2 = _gating.balanced_accuracy(y_true, y_pred > mid2)
        if s1 > s2:
            high = mid2
            if s1 > best_score:
                best_score, best_thresh = s1, mid1
        else:
            low = mid1
            if s2 > best_score:
                best_score, best_thresh = s2, mid2
    return best_thresh, best_score
