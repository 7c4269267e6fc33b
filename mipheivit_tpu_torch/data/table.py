"""A small column table read with the stdlib ``csv`` module.

The port reads its tile and slide dataframes without pandas, which the
machine with the card need not have. ``Table`` holds one numpy array per column and
offers what the data layer and the trainer use of a ``pandas.DataFrame``:
``len``, ``columns``, ``table[col]`` (the column's array), ``table[[cols]]``
(a sub-table), ``row(i)`` (one row as a dict), ``take``, ``filter``,
``unique`` and ``replace``; and what the single-cell frames use:
``concat``, ``isin``, ``rename``, ``drop``, ``sample``, ``groupby_sum``,
``merge`` and ``to_csv``, sort-based in numpy. ``read_csv`` infers each column's type as
``pandas.read_csv`` does for the columns these CSVs hold: all integers ->
int64; all numbers -> float64, empty cells NaN; all ``True``/``False`` ->
bool; anything else -> str (an object array, empty cells None where pandas
has NaN). A column of empty cells only is float64 NaN, as in pandas.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|nan)\Z",
                    re.IGNORECASE)
_BOOL = {"True": True, "False": False, "TRUE": True, "FALSE": False,
         "true": True, "false": False}


def _column(cells: List[str]) -> np.ndarray:
    present = [c for c in cells if c != ""]
    if not present:
        return np.full(len(cells), np.nan)
    if len(present) == len(cells) and all(_INT.match(c) for c in present):
        return np.array([int(c) for c in cells], np.int64)
    if all(_FLOAT.match(c) for c in present):
        return np.array([float(c) if c != "" else np.nan for c in cells], np.float64)
    if len(present) == len(cells) and all(c in _BOOL for c in present):
        return np.array([_BOOL[c] for c in cells], bool)
    out = np.empty(len(cells), object)
    out[:] = [c if c != "" else None for c in cells]
    return out


class Table:
    """Columns of equal length, in order, each a numpy array."""

    def __init__(self, columns: Dict[str, Iterable]):
        self._cols: Dict[str, np.ndarray] = {}
        for name, values in columns.items():
            arr = np.asarray(values)
            if arr.dtype.kind == "U":       # str columns are object arrays, as in pandas
                arr = arr.astype(object)
            self._cols[name] = arr
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {sorted(lengths)}")

    @classmethod
    def read_csv(cls, path: Union[str, Path], usecols: Sequence[str] = None) -> "Table":
        """The CSV's columns (those named in ``usecols`` only, in the file's
        order, when given)."""
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            rows = [r for r in reader if r]
        for i, r in enumerate(rows):
            if len(r) != len(header):
                raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the header "
                                 f"{len(header)}")
        if usecols is not None:
            missing = set(usecols) - set(header)
            if missing:
                raise ValueError(f"{path}: no column(s) {sorted(missing)}")
        return cls({name: _column([r[j] for r in rows]) for j, name in enumerate(header)
                    if usecols is None or name in usecols})

    @classmethod
    def from_records(cls, records: Sequence[Dict]) -> "Table":
        names = list(records[0]) if records else []
        return cls({n: [r[n] for r in records] for n in names})

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        return Table({name: self._cols[name] for name in key})

    def row(self, i: int) -> Dict:
        return {name: col[i] for name, col in self._cols.items()}

    def take(self, idx) -> "Table":
        idx = np.asarray(idx)
        return Table({name: col[idx] for name, col in self._cols.items()})

    def filter(self, mask) -> "Table":
        return self.take(np.flatnonzero(np.asarray(mask, bool)))

    def unique(self, name: str) -> list:
        """The column's distinct values in order of first appearance."""
        return list(dict.fromkeys(self._cols[name].tolist()))

    def replace(self, name: str, values) -> "Table":
        """A copy with column ``name`` set to ``values``."""
        return Table({**self._cols, name: values})

    def mapping(self, key: str, value: str) -> Dict:
        """``{key: value}`` over the rows (``set_index(key)[value].to_dict()``)."""
        return dict(zip(self._cols[key].tolist(), self._cols[value].tolist()))

    # -- what the cell frames use (the JAX package does these in pandas) ----
    @classmethod
    def concat(cls, tables: Sequence["Table"]) -> "Table":
        """The rows of ``tables`` in order (``pd.concat``); all hold the
        first one's columns."""
        names = tables[0].columns
        for t in tables[1:]:
            if set(t.columns) != set(names):
                raise ValueError(f"concat of different columns: {names} and {t.columns}")
        return cls({n: np.concatenate([t._cols[n] for t in tables]) for n in names})

    def isin(self, name: str, values) -> np.ndarray:
        """The rows whose ``name`` is one of ``values``, as a bool mask."""
        return np.isin(self._cols[name], np.asarray(list(values), dtype=self._cols[name].dtype))

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(n, n): v for n, v in self._cols.items()})

    def drop(self, names: Iterable[str]) -> "Table":
        names = set(names)
        return Table({n: v for n, v in self._cols.items() if n not in names})

    def sample(self, n: int, random_state: int = 42) -> "Table":
        """``n`` rows drawn without replacement, the rows ``DataFrame.sample(n,
        random_state=...)`` draws: ``RandomState(seed).choice(len, n, False)``."""
        return self.take(np.random.RandomState(random_state).choice(len(self), n, replace=False))

    def _codes(self, keys: Sequence[str]) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Each row's group code, the groups sorted by ``keys`` in turn, and
        each key column's value per group."""
        code = np.zeros(len(self), np.int64)
        for name in keys:
            values, inverse = np.unique(self._cols[name], return_inverse=True)
            code = code * len(values) + inverse.reshape(-1)
        _, first, code = np.unique(code, return_index=True, return_inverse=True)
        return code.reshape(-1), [self._cols[name][first] for name in keys]

    def groupby_sum(self, keys: Union[str, Sequence[str]], columns: Sequence[str]) -> "Table":
        """``groupby(keys)[columns].sum().reset_index()``: one row per
        distinct key, sorted by the keys; bool and integer columns sum to
        int64, floats to float64."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        code, key_values = self._codes(keys)
        order = np.argsort(code, kind="stable")
        starts = np.flatnonzero(np.r_[True, code[order][1:] != code[order][:-1]])
        out = dict(zip(keys, key_values))
        for name in columns:
            col = self._cols[name]
            col = col.astype(np.int64) if col.dtype.kind in "biu" else col.astype(np.float64)
            out[name] = (np.add.reduceat(col[order], starts) if len(col)
                         else np.zeros(0, col.dtype))
        return Table(out)

    def merge(self, right: "Table", left_on: Sequence[str], right_on: Sequence[str],
              how: str = "left") -> "Table":
        """``self.merge(right, left_on=..., right_on=..., how=...)`` for
        ``how`` "left" or "inner": the left rows in order, each repeated
        once per matching right row (a left row without one is kept with
        missing values by "left": NaN, which turns int and bool columns
        into float64 and object ones). Columns: the left ones, then the
        right ones, less a right key of the same name as its left key."""
        if how not in ("left", "inner"):
            raise ValueError(f"how={how!r}")
        n_left = len(self)
        both = Table.concat([
            Table({f"k{i}": self._key(a) for i, a in enumerate(left_on)}),
            Table({f"k{i}": right._key(b) for i, b in enumerate(right_on)})])
        code, _ = both._codes([f"k{i}" for i in range(len(left_on))])
        lcode, rcode = code[:n_left], code[n_left:]
        r_order = np.argsort(rcode, kind="stable")
        r_sorted = rcode[r_order]
        lo = np.searchsorted(r_sorted, lcode, "left")
        n_match = np.searchsorted(r_sorted, lcode, "right") - lo
        reps = np.maximum(n_match, 1) if how == "left" else n_match
        left_idx = np.repeat(np.arange(n_left), reps)
        offset = np.arange(len(left_idx)) - np.repeat(np.cumsum(reps) - reps, reps)
        matched = np.repeat(n_match, reps) > 0
        right_idx = np.where(matched, r_order[np.minimum(np.repeat(lo, reps) + offset,
                                                         max(len(r_order) - 1, 0))], -1)
        out = {n: v[left_idx] for n, v in self._cols.items()}
        shared = {b for a, b in zip(left_on, right_on) if a == b}
        for name, col in right._cols.items():
            if name in shared:
                continue
            if name in out:
                raise ValueError(f"merge: column {name!r} on both sides")
            taken = col[np.maximum(right_idx, 0)] if len(col) else np.zeros(len(right_idx),
                                                                               col.dtype)
            if not matched.all():
                if taken.dtype.kind in "iuf":
                    taken = taken.astype(np.float64)
                    taken[~matched] = np.nan
                else:
                    taken = taken.astype(object)
                    taken[~matched] = np.nan
            out[name] = taken
        return Table(out)

    def _key(self, name: str) -> np.ndarray:
        """A join key column: unsigned ids as int64, so that they compare
        with signed labels."""
        col = self._cols[name]
        return col.astype(np.int64) if col.dtype.kind == "u" else col

    def to_csv(self, path: Union[str, Path]) -> None:
        """``to_csv(path, index=False)``: bools as True/False, NaN and None
        as empty cells, floats at full precision."""
        def cells(col: np.ndarray) -> List[str]:
            if col.dtype.kind == "f":
                return ["" if v != v else repr(v) for v in col.astype(np.float64).tolist()]
            if col.dtype.kind == "O":
                return ["" if v is None or (isinstance(v, float) and v != v) else str(v)
                        for v in col.tolist()]
            return [str(v) for v in col.tolist()]

        columns = [cells(c) for c in self._cols.values()]
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(self.columns)
            writer.writerows(zip(*columns))
