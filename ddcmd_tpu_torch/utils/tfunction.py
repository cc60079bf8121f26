"""Tabulated functions: file-backed f(x) (and multi-column families).

Counterpart of ddcmd_tpu/utils/tfunction.py (reference simutil
tfunction.c / table_function.c: text tables driving the TABULAR EAM
forms).  File format: whitespace columns, '#' or '//' comments; column 0
is x, columns 1..k are values.  The host side (`from_file`,
`from_columns`) is numpy, copied from the JAX package (importing
ddcmd_tpu imports jax): the columns are resampled onto a uniform grid of
`n_grid` points with np.interp and differentiated with np.gradient.
The device lookup of the tables is the TABULAR EAM form's
(potentials/eam._tab_lookup: a linear interpolation with the reference's
clamp of t to [0, m - 1.001]).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TabulatedFunction:
    x0: float
    dx: float
    values: np.ndarray      # (k, m) resampled columns
    derivs: np.ndarray      # (k, m)
    x_max: float

    @classmethod
    def from_file(cls, path: str, n_grid: int = 2048) -> "TabulatedFunction":
        rows = []
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].split("//")[0].strip()
                if not line:
                    continue
                rows.append([float(t) for t in line.split()])
        data = np.asarray(rows, dtype=np.float64)
        data = data[np.isfinite(data).all(axis=1)]  # drop inf/nan rows
        return cls.from_columns(data[:, 0], data[:, 1:].T, n_grid)

    @classmethod
    def from_columns(cls, x, cols, n_grid: int = 2048) -> "TabulatedFunction":
        x = np.asarray(x, dtype=np.float64)
        cols = np.atleast_2d(np.asarray(cols, dtype=np.float64))
        order = np.argsort(x)
        x = x[order]
        cols = cols[:, order]
        xg = np.linspace(x[0], x[-1], n_grid)
        vals = np.stack([np.interp(xg, x, c) for c in cols])
        dx = xg[1] - xg[0]
        der = np.gradient(vals, dx, axis=1)
        return cls(x0=float(xg[0]), dx=float(dx), values=vals, derivs=der,
                   x_max=float(x[-1]))
