"""Minimal astropy.table.Table stand-in (column dict with mask indexing).

The package does not depend on astropy; the reference passes catalogs as
astropy Tables. This covers the subset the pipelines use: string-key column
access, boolean-mask/index row selection, len, colnames, add/replace columns.

A copy of sfft_tpu/utils/table.py (numpy, on the host).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np


class Table:
    def __init__(self, data: Dict[str, np.ndarray] = None):
        self._cols: Dict[str, np.ndarray] = {}
        if data:
            n = None
            for k, v in data.items():
                arr = np.asarray(v)
                if n is None:
                    n = len(arr)
                assert len(arr) == n, f"column {k} length mismatch"
                self._cols[k] = arr

    @property
    def colnames(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __contains__(self, key: str) -> bool:
        return key in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, (list, tuple)) and key and isinstance(key[0], str):
            return Table({k: self._cols[k] for k in key})
        # boolean mask / index array / slice -> row selection
        return Table({k: v[key] for k, v in self._cols.items()})

    def __setitem__(self, key: str, value):
        arr = np.asarray(value)
        if self._cols:
            assert len(arr) == len(self)
        self._cols[key] = arr

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self._cols.items()})

    def add_column(self, col, name: str):
        self[name] = col

    def remove_column(self, name: str):
        del self._cols[name]

    def __repr__(self):
        return f"<Table rows={len(self)} cols={self.colnames}>"


def vstack(tables: Iterable[Table]) -> Table:
    tables = list(tables)
    keys = tables[0].colnames
    return Table({k: np.concatenate([t[k] for t in tables]) for k in keys})
