"""The gating statistics of the single-cell metrics, without scikit-learn.

``metrics/cell.py`` of the JAX package takes these from scikit-learn, which
the machine with the card need not have. Each is written here in numpy
(float64) with scikit-learn's definitions:

  * ``fit_scaler``: ``StandardScaler`` (population std; a constant column
    gets scale 1);
  * ``fit_logistic``: ``LogisticRegression(class_weight="balanced")`` with
    its defaults (L2, C = 1, an unpenalised intercept), fitted to
    convergence by Newton's method with a backtracking line search on the
    (d + 1)-dimensional problem, vectorised over the rows;
    ``fit_one_vs_rest`` fits one per column of a multilabel target, and a
    column with one class becomes a constant predictor, as in
    ``OneVsRestClassifier``;
  * ``roc_auc`` (Mann-Whitney, ties at their average rank),
    ``balanced_accuracy`` and ``f1`` (0 without positives) for binary labels.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

_MAX_NEWTON = 100


def fit_scaler(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(mean, scale)`` of the columns, as ``StandardScaler().fit(x)``."""
    x = np.asarray(x, np.float64)
    mean = x.mean(0)
    var = x.var(0)
    n = x.shape[0]
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    return mean, scale


def balanced_weights(y: np.ndarray) -> np.ndarray:
    """Per-row weights ``n / (2 * n_class)`` of ``class_weight="balanced"``."""
    y = np.asarray(y, bool)
    n_pos = int(y.sum())
    n = y.size
    return np.where(y, n / (2.0 * n_pos), n / (2.0 * (n - n_pos)))


def logistic_objective(x, y, coef, intercept, weights) -> float:
    """``sum_i w_i * logloss_i + ||coef||^2 / 2``: scikit-learn's objective
    at C = 1, up to a constant factor."""
    z = np.asarray(x, np.float64) @ coef + intercept
    y = np.asarray(y, np.float64)
    return float(np.sum(weights * (np.logaddexp(0.0, z) - y * z)) + 0.5 * coef @ coef)


def fit_logistic(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, float]:
    """``(coef [d], intercept)`` minimising ``logistic_objective`` with
    balanced class weights; ``y`` must hold both classes."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, bool)
    n, d = x.shape
    weights = balanced_weights(y)
    design = np.concatenate([x, np.ones((n, 1))], axis=1)
    penalty = np.ones(d + 1)
    penalty[-1] = 0.0                       # the intercept is not penalised
    yf = y.astype(np.float64)

    def objective(beta):
        return logistic_objective(x, yf, beta[:d], beta[d], weights)

    beta = np.zeros(d + 1)
    f = objective(beta)
    for _ in range(_MAX_NEWTON):
        z = design @ beta
        p = 0.5 * (1.0 + np.tanh(0.5 * z))  # the sigmoid, without overflow
        grad = design.T @ (weights * (p - yf)) + penalty * beta
        hess = (design * (weights * p * (1.0 - p))[:, None]).T @ design + np.diag(penalty)
        step = np.linalg.solve(hess, grad)
        decrement = float(grad @ step)      # the Newton decrement, squared
        if decrement <= 1e-20 * max(abs(f), 1.0):
            break
        t = 1.0
        while True:
            candidate = beta - t * step
            f_new = objective(candidate)
            if f_new <= f - 0.25 * t * decrement or t < 1e-10:
                break
            t *= 0.5
        if f_new > f:
            break
        beta, f = candidate, f_new
    return beta[:d], float(beta[d])


@dataclasses.dataclass
class OneVsRest:
    """One logistic regression per label column on standardised inputs;
    ``constant[j]`` is the class of a column that held only one."""

    coef: np.ndarray          # [n_labels, d]
    intercept: np.ndarray     # [n_labels]
    constant: List[object]    # None, or the single class (0 or 1) of the column

    def decision(self, xs: np.ndarray) -> np.ndarray:
        return np.asarray(xs, np.float64) @ self.coef.T + self.intercept

    def predict_proba(self, xs: np.ndarray) -> np.ndarray:
        proba = 1.0 / (1.0 + np.exp(-self.decision(xs)))
        for j, cls in enumerate(self.constant):
            if cls is not None:
                proba[:, j] = float(cls)
        return proba

    def predict(self, xs: np.ndarray) -> np.ndarray:
        hard = self.decision(xs) > 0
        for j, cls in enumerate(self.constant):
            if cls is not None:
                hard[:, j] = bool(cls)
        return hard


def fit_one_vs_rest(xs: np.ndarray, y: np.ndarray) -> OneVsRest:
    """``OneVsRestClassifier(LogisticRegression(class_weight="balanced"))``
    on a multilabel ``y [n, n_labels]``."""
    y = np.asarray(y, bool)
    d = xs.shape[1]
    coef = np.zeros((y.shape[1], d))
    intercept = np.zeros(y.shape[1])
    constant: List[object] = []
    for j in range(y.shape[1]):
        classes = np.unique(y[:, j])
        if len(classes) == 1:
            constant.append(int(classes[0]))
            continue
        constant.append(None)
        coef[j], intercept[j] = fit_logistic(xs, y[:, j])
    return OneVsRest(coef, intercept, constant)


def _average_ranks(score: np.ndarray) -> np.ndarray:
    """1-based ranks, ties at their average (``scipy.stats.rankdata``)."""
    order = np.argsort(score, kind="mergesort")
    ordered = score[order]
    new = np.r_[True, ordered[1:] != ordered[:-1]]
    group = np.cumsum(new) - 1
    starts = np.r_[np.flatnonzero(new), len(score)]
    average = 0.5 * (starts[:-1] + starts[1:] + 1)
    ranks = np.empty(len(score))
    ranks[order] = average[group]
    return ranks


def roc_auc(y_true, score) -> float:
    """The area under the ROC curve; NaN when ``y_true`` has one class."""
    y = np.asarray(y_true, bool)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _average_ranks(np.asarray(score, np.float64))
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def balanced_accuracy(y_true, y_pred) -> float:
    """The mean recall over the classes present in ``y_true``."""
    y, p = np.asarray(y_true, bool), np.asarray(y_pred, bool)
    recalls = [np.sum(p[y == cls] == cls) / np.sum(y == cls)
               for cls in (False, True) if np.any(y == cls)]
    return float(np.mean(np.asarray(recalls, np.float64)))


def f1(y_true, y_pred) -> float:
    """``2 tp / (2 tp + fp + fn)`` for the positive class; 0 when there are
    no positives in either."""
    y, p = np.asarray(y_true, bool), np.asarray(y_pred, bool)
    tp = int(np.sum(y & p))
    denom = int(np.sum(y)) + int(np.sum(p))
    return 0.0 if denom == 0 else float(2 * tp / denom)
