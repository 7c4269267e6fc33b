"""Single-cell metrics in the PyTorch port against the JAX package.

The same predictions (numpy seeds; nuclei split across tiles, cells absent
from the nuclei CSV, values past the +-0.9 clip) go through
``mipheivit_tpu.metrics.cell.CellMetrics`` and the port's:

  * the per-cell tables: the same rows in the same order, cell ids and
    areas exactly, means within 1 / area + 1e-6 (the tables hold the means
    of the sums quantised at ``* 255``, so this is 1 / (255 * area) on the
    predictions' 0-1 scale: a truncation may flip by one unit when the sums
    are added in another order);
  * ``compute`` on the same accumulated statistics with the JAX package's
    head: every key within 1e-9;
  * the port's own fit (Newton, ``metrics/_gating.py``) against
    scikit-learn's: the folded head within 2e-3 of scikit-learn's fit run to
    convergence (and the fit before folding within 1e-6), the port's
    objective at or below that of scikit-learn's default fit (the JAX
    package's) + 1e-8, and the metrics of its own head within 2e-3 (AUC)
    and 1e-2 (balanced accuracy, F1) of the JAX package's;
  * a marker with one class (a constant predictor), ``find_best_threshold``
    exactly, and AUC, balanced accuracy and F1 against scikit-learn at
    random inputs with ties within 1e-12.
"""

import copy
import csv

import numpy as np
import pytest
import torch

from mipheivit_tpu_torch.data.table import Table
from mipheivit_tpu_torch.metrics import _gating
from mipheivit_tpu_torch.metrics.cell import CellMetrics, LogRegHead, find_best_threshold

torch.set_num_threads(2)

MARKERS = ["Hoechst", "CD31", "CD3e", "CD8a"]       # Hoechst is excluded
SLIDES = ["s0", "s1"]
N_LABELS = 60           # labels per slide; the CSVs list 1..50 only
HW = 48
KEY_TOL = 1e-9
HEAD_ATOL, AUC_ATOL, HARD_ATOL = 2e-3, 2e-3, 1e-2
CONVERGED_ATOL = 1e-6   # the standardised fit against scikit-learn's at tol 1e-12
OBJ_SLACK = 1e-8
STAT_TOL = 1e-12


def _positive(label, j):
    """Ground truth of marker j (CD31, CD3e, CD8a) of a cell."""
    return [label % 2 == 0, label % 3 == 0, label % 5 == 0][j]


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("cells")
    rows = []
    for s in SLIDES:
        path = root / f"{s}_cells.csv"
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["label", "x", "CD31_pos", "CD3e_pos", "CD8a_pos"])
            for label in range(1, 51):
                writer.writerow([label, label * 3] + [_positive(label, j) for j in range(3)])
        rows.append({"in_slide_name": s, "nuclei_csv_path": str(path)})
    with open(root / "slides.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["in_slide_name", "nuclei_csv_path"])
        writer.writeheader()
        writer.writerows(rows)
    return root / "slides.csv"


def _batches(seed, n_batches=4, b=4):
    """Predictions [b, HW, HW, 4] whose marker channels are brighter, with
    noise, for positive cells; 3x3 grids of 12x12 nuclei, with labels
    shared between tiles of a slide."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        nuclei = np.zeros((b, HW, HW), np.int32)
        preds = rng.uniform(-1.0, -0.5, (b, HW, HW, len(MARKERS))).astype(np.float32)
        for i in range(b):
            labels = rng.choice(np.arange(1, N_LABELS + 1), 9, replace=False)
            for j, lab in enumerate(labels):
                y, x = 3 + 15 * (j // 3), 3 + 15 * (j % 3)
                size = int(rng.integers(4, 13))
                nuclei[i, y:y + size, x:x + 12] = lab
                for m in range(3):
                    level = 0.4 if _positive(lab, m) else -0.3
                    preds[i, y:y + size, x:x + 12, m + 1] = (
                        level + 0.5 * rng.standard_normal((size, 12)))
        names = [SLIDES[int(k)] for k in rng.integers(0, 2, b)]
        out.append((preds, nuclei, names))
    return out


def _pair(slides, batches, **kw):
    """The JAX package's and the port's ``CellMetrics`` after the same
    updates."""
    import jax.numpy as jnp
    import pandas as pd

    from mipheivit_tpu.metrics.cell import CellMetrics as JaxCellMetrics

    jax_cm = JaxCellMetrics(pd.read_csv(slides), MARKERS, **kw)
    port_cm = CellMetrics(Table.read_csv(slides), MARKERS, **kw)
    for preds, nuclei, names in batches:
        jax_cm.update(jnp.asarray(preds), jnp.asarray(nuclei), names)
        port_cm.update(torch.from_numpy(preds), torch.from_numpy(nuclei), names)
    return jax_cm, port_cm


def _assert_tables_match(got: Table, want, marker_pred_cols):
    """``got`` (port) against ``want`` (pandas): columns, rows, ids and
    areas exactly, means within the quantisation tolerance."""
    assert got.columns == list(want.columns)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got["cell_id"], want["cell_id"].to_numpy())
    assert got["slide_name"].tolist() == [str(s) for s in want["slide_name"]]
    if "area" in want.columns:
        area = want["area"].to_numpy()
        np.testing.assert_array_equal(got["area"], area)
    for col in got.columns:
        if col.endswith("_pred"):
            if "area" in want.columns:
                tol = 1.0 / area + 1e-6
                assert (np.abs(got[col] - want[col].to_numpy()) <= tol).all(), col
            else:
                np.testing.assert_allclose(got[col], want[col].to_numpy(), atol=1 / 21 + 1e-6)
        elif col not in ("cell_id", "slide_name", "area"):
            np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)


@pytest.mark.parametrize("min_area", [20, 60])
def test_cell_tables_match_jax(slides, min_area):
    jax_cm, port_cm = _pair(slides, _batches(0), min_area=min_area, capacity=64)
    assert port_cm.marker_names == ["CD31", "CD3e", "CD8a"] and port_cm.marker_idxs == [1, 2, 3]
    want, got = jax_cm.get_dataframe_cell_pred(), port_cm.get_dataframe_cell_pred()
    _assert_tables_match(got, want, port_cm.marker_pred_cols)
    assert (got["area"] > min_area).all()
    want = jax_cm.get_dataframe_cell_pred_target()
    got = port_cm.get_dataframe_cell_pred_target()
    _assert_tables_match(got, want, port_cm.marker_pred_cols)
    assert (got["label"] <= 50).all() and len(got) < len(port_cm.get_dataframe_cell_pred())


def _same_accumulation(jax_cm, port_cm):
    port_cm._acc = copy.deepcopy(jax_cm._acc)


def _keys_match(got: dict, want: dict, tol: float = KEY_TOL, hard_tol: float = None):
    numeric = {k for k, v in want.items() if isinstance(v, (float, np.floating))}
    assert numeric == {k for k, v in got.items() if isinstance(v, (float, np.floating))}
    for key in numeric:
        atol = tol
        if hard_tol is not None and ("balanced_acc" in key or key.endswith("f1")):
            atol = hard_tol
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)


def test_compute_with_the_jax_head_matches(slides):
    jax_cm, port_cm = _pair(slides, _batches(1), capacity=64)
    _same_accumulation(jax_cm, port_cm)
    snapshot = copy.deepcopy(jax_cm._acc)
    head = jax_cm.compute()["logreg_head"]
    jax_cm._acc = snapshot
    want, want_df = jax_cm.compute(logreg_head=head, return_dataframe=True)
    got, got_df = port_cm.compute(logreg_head=LogRegHead(head.weight, head.bias),
                                  return_dataframe=True)
    _keys_match(got, want)
    assert {"CD31_pos_auc", "CD8a_pos_f1"} <= set(got)
    assert set(got["state_dict"]) == {"weight", "bias"}
    assert all(len(v) == 0 for v in port_cm._acc.values())
    _assert_tables_match(got_df, want_df, port_cm.marker_pred_cols)


def test_own_fit_against_sklearn(slides):
    from sklearn.linear_model import LogisticRegression
    from sklearn.multiclass import OneVsRestClassifier
    from sklearn.preprocessing import StandardScaler

    jax_cm, port_cm = _pair(slides, _batches(2, n_batches=8), capacity=64)
    _same_accumulation(jax_cm, port_cm)
    table = port_cm.get_dataframe_cell_pred_target()
    x = np.stack([table[c] for c in port_cm.marker_pred_cols], 1)
    y = np.stack([table[c] for c in port_cm.marker_cols], 1)
    scaler = StandardScaler().fit(x)
    xs = scaler.transform(x)
    sk = OneVsRestClassifier(LogisticRegression(class_weight="balanced", random_state=42))
    sk.fit(xs, y)
    mine = _gating.fit_one_vs_rest(xs, y)

    # the folded head against scikit-learn's run to convergence (its
    # default tol of 1e-4 stops ~1e-3 short of the optimum in the intercept
    # on these cells; the objective below holds the port against it)
    tight = OneVsRestClassifier(LogisticRegression(class_weight="balanced", random_state=42,
                                                   tol=1e-12, max_iter=10000)).fit(xs, y)
    coef = np.vstack([e.coef_ for e in tight.estimators_])
    intercept = np.array([e.intercept_[0] for e in tight.estimators_])
    got = port_cm.train_logistic_regression(table, return_metrics=False)
    np.testing.assert_allclose(got.weight, coef / scaler.scale_, rtol=0, atol=HEAD_ATOL)
    np.testing.assert_allclose(got.bias, intercept - (coef * scaler.mean_ / scaler.scale_).sum(1),
                               rtol=0, atol=HEAD_ATOL)
    np.testing.assert_allclose(mine.coef, coef, rtol=0, atol=CONVERGED_ATOL)
    np.testing.assert_allclose(mine.intercept, intercept, rtol=0, atol=CONVERGED_ATOL)

    # the objective at the port's fit and at scikit-learn's, on the same inputs
    for j, est in enumerate(sk.estimators_):
        w = _gating.balanced_weights(y[:, j])
        ours = _gating.logistic_objective(xs, y[:, j], mine.coef[j], mine.intercept[j], w)
        theirs = _gating.logistic_objective(xs, y[:, j], est.coef_.ravel(), est.intercept_[0], w)
        assert ours <= theirs + OBJ_SLACK, (j, ours, theirs)

    # the metrics of each package's own head
    snapshot = copy.deepcopy(jax_cm._acc)
    want_m = jax_cm.compute()
    port_cm._acc = snapshot
    got_m = port_cm.compute()
    _keys_match({k: v for k, v in got_m.items() if "logreg" in k or "balanced" in k
                 or k.endswith("f1")},
                {k: v for k, v in want_m.items() if "logreg" in k or "balanced" in k
                 or k.endswith("f1")}, AUC_ATOL, HARD_ATOL)
    _keys_match({k: v for k, v in got_m.items() if k.endswith("auc")},
                {k: v for k, v in want_m.items() if k.endswith("auc")})


def test_results_and_a_constant_column_match_jax(slides):
    """Scored on other cells (``test_dataframe``) with a marker that has one
    class in the training cells: a constant predictor, folded into a zero
    row and bias."""
    jax_cm, port_cm = _pair(slides, _batches(3, n_batches=6), capacity=64)
    _same_accumulation(jax_cm, port_cm)
    table = port_cm.get_dataframe_cell_pred_target()
    frame = jax_cm.get_dataframe_cell_pred_target()
    train = table.filter(table["slide_name"] == "s0")
    test = table.filter(table["slide_name"] == "s1")
    train = train.replace("CD8a_pos", np.zeros(len(train), bool))
    ftrain = frame[frame["slide_name"] == "s0"].copy()
    ftest = frame[frame["slide_name"] == "s1"]
    ftrain["CD8a_pos"] = False
    got_r, got_h = port_cm.train_logistic_regression(train, test)
    want_r, want_h = jax_cm.train_logistic_regression(ftrain, ftest)
    assert not got_h.weight[2].any() and got_h.bias[2] == 0.0
    assert not want_h.weight[2].any() and want_h.bias[2] == 0.0
    for g, w in zip(got_r, want_r):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=AUC_ATOL)
        np.testing.assert_allclose(g[2:], w[2:], rtol=0, atol=HARD_ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_find_best_threshold_matches_jax(seed):
    from mipheivit_tpu.metrics.cell import find_best_threshold as jax_find

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 300)
    p = np.round(y * 3.0 + rng.standard_normal(300) * 2 + 3, 1)
    assert find_best_threshold(y, p) == jax_find(y, p)


@pytest.mark.parametrize("seed", range(6))
def test_statistics_match_sklearn(seed):
    from sklearn.metrics import balanced_accuracy_score, f1_score, roc_auc_score

    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(5, 400))
    y = rng.random(n) < rng.uniform(0.05, 0.95)
    y[:2] = [True, False]
    score = np.round(rng.standard_normal(n) + y, int(rng.integers(0, 3)))   # ties
    pred = rng.random(n) < 0.4
    assert abs(_gating.roc_auc(y, score) - roc_auc_score(y, score)) <= STAT_TOL
    assert abs(_gating.balanced_accuracy(y, pred) - balanced_accuracy_score(y, pred)) <= STAT_TOL
    assert abs(_gating.f1(y, pred) - f1_score(y, pred)) <= STAT_TOL
    nothing = np.zeros(n, bool)
    assert _gating.f1(nothing, nothing) == f1_score(nothing, nothing, zero_division=0) == 0.0
    assert _gating.balanced_accuracy(nothing, pred) == balanced_accuracy_score(nothing, pred)
    mean, scale = _gating.fit_scaler(np.c_[score, np.ones(n)])
    assert scale[1] == 1.0 and mean[1] == 1.0
