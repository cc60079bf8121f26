"""THERMALIZE transform: draw Maxwell-Boltzmann velocities.

A copy of ddcmd_tpu/transforms/thermalize.py (numpy only; importing the
JAX package imports jax).  Reference: ddcMD src/thermalizeTransform.c /
thermalize.c.  v_i ~ N(0, kB T / m_i) per axis, optional COM removal
(seeded, host-side numpy -- transforms run outside the step loop).
"""

from __future__ import annotations

import numpy as np

from ..objects import units as U


def thermalize_velocities(mass: np.ndarray, T: float, seed: int = 0,
                          remove_vcm: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = len(mass)
    sigma = np.sqrt(U.kB * T / np.asarray(mass, dtype=np.float64))
    v = rng.standard_normal((n, 3)) * sigma[:, None]
    if remove_vcm:
        p = (mass[:, None] * v).sum(axis=0)
        v -= p / mass.sum()
    return v
