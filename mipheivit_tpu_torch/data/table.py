"""A small column table read with the stdlib ``csv`` module.

The port reads its tile and slide dataframes without pandas, which the
machine with the card need not have. ``Table`` holds one numpy array per column and
offers what the data layer and the trainer use of a ``pandas.DataFrame``:
``len``, ``columns``, ``table[col]`` (the column's array), ``table[[cols]]``
(a sub-table), ``row(i)`` (one row as a dict), ``take``, ``filter``,
``unique`` and ``replace``. ``read_csv`` infers each column's type as
``pandas.read_csv`` does for the columns these CSVs hold: all integers ->
int64; all numbers -> float64, empty cells NaN; all ``True``/``False`` ->
bool; anything else -> str (an object array, empty cells None where pandas
has NaN). A column of empty cells only is float64 NaN, as in pandas.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Union

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
    def read_csv(cls, path: Union[str, Path]) -> "Table":
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            rows = [r for r in reader if r]
        for i, r in enumerate(rows):
            if len(r) != len(header):
                raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the header "
                                 f"{len(header)}")
        return cls({name: _column([r[j] for r in rows]) for j, name in enumerate(header)})

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
