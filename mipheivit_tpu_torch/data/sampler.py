"""Balanced positive tile sampler (reference: src/dataset.py:486-536).

The port's copy of ``mipheivit_tpu/data/sampler.py``, on a ``data.table.Table``
(or anything whose ``table[col]`` is the column's values). Picks the marker
``{name}_count`` column with the most tiles above the integer threshold,
then resamples each epoch's indices to (1 - other_percent) positives /
other_percent rest, with fractional up- or down-sampling. Epoch indices are
regenerated at every ``epoch_indices`` call, like the reference's
``__iter__``; the draws are the JAX package's, in the same order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class BalancedPositiveSampler:
    def __init__(self, dataframe, class_names: Sequence[str], thresh: int,
                 other_percent: float = 0.20, seed: int = 0):
        if not isinstance(thresh, (int, np.integer)) or thresh <= 0:
            raise ValueError("thresh must be a positive int")
        self.total_size = len(dataframe)
        self.other_percent = other_percent
        self.thresh = int(thresh)
        self._rng = np.random.default_rng(seed)

        column_names = [f"{name}_count" for name in class_names]
        counts = [int((np.asarray(dataframe[c]) > thresh).sum()) for c in column_names]
        self.column_name = column_names[int(np.argmax(counts))]
        self._column = np.asarray(dataframe[self.column_name]).copy()

    def _sampling(self, idxs: np.ndarray, factor: float) -> np.ndarray:
        if factor <= 0:
            raise ValueError("factor must be greater than 0")
        if factor == 1:
            return idxs
        if factor > 1:
            int_factor = int(factor)
            up = np.repeat(idxs, int_factor)
            residual = factor - int_factor
            up_res = self._rng.choice(idxs, size=int(len(idxs) * residual), replace=False)
            return np.hstack((up, up_res))
        return self._rng.choice(idxs, size=int(len(idxs) * factor), replace=False)

    def epoch_indices(self) -> np.ndarray:
        other = np.flatnonzero(self._column <= self.thresh)
        pos = np.flatnonzero(self._column > self.thresh)
        factor_pos = int(self.total_size * (1 - self.other_percent)) / len(pos)
        factor_other = int(self.total_size * self.other_percent) / len(other)
        combined = np.hstack((
            self._sampling(pos, factor_pos),
            self._sampling(other, factor_other),
        ))
        self._rng.shuffle(combined)
        return combined

    def __iter__(self):
        return iter(self.epoch_indices().tolist())

    def __len__(self):
        return self.total_size
