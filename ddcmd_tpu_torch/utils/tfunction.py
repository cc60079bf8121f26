"""Tabulated functions: file-backed f(x) (and multi-column families).

Counterpart of ddcmd_tpu/utils/tfunction.py (reference simutil
tfunction.c / table_function.c: text tables driving the TABULAR EAM
forms).  File format: whitespace columns, '#' or '//' comments; column 0
is x, columns 1..k are values.  The host side (`from_file`,
`from_columns`) is numpy, copied from the JAX package (importing
ddcmd_tpu imports jax): the columns are resampled onto a uniform grid of
`n_grid` points with np.interp and differentiated with np.gradient.
`device_tables` and `teval` are the device side in torch: a linear
interpolation with the reference's clamp of t to [0, m - 1.001].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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

    def device_tables(self, dtype=torch.float32, device="cpu"):
        return dict(x0=torch.tensor(self.x0, dtype=dtype, device=device),
                    inv_dx=torch.tensor(1.0 / self.dx, dtype=dtype,
                                        device=device),
                    values=torch.as_tensor(self.values, dtype=dtype,
                                           device=device),
                    derivs=torch.as_tensor(self.derivs, dtype=dtype,
                                           device=device),
                    n=self.values.shape[1])


def teval(tab: dict, x, col: int = 0, derivative: bool = False):
    """Linear-interpolated lookup; clamps outside the domain (t to
    [0, n - 1.001], so t + 1 stays inside the table)."""
    src = tab["derivs"] if derivative else tab["values"]
    t = (x - tab["x0"]) * tab["inv_dx"]
    t = torch.clamp(t, 0.0, tab["n"] - 1.001)
    i = torch.floor(t).long()
    frac = t - i
    v0 = src[col][i]
    v1 = src[col][i + 1]
    return v0 + frac * (v1 - v0)
