"""testForce master: finite-difference force consistency check.

Counterpart of ddcmd_tpu/run/testforce.py (reference forcetest, ddcMD
src/forcetest.c:10, dispatched by masters.c:125-133).  Displaces sampled
particles by +-h along each axis and compares -dE/dx with the analytic
force, on the (N,K)-list engine as the JAX master does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.system import build_system, plan_grid
from ..nbr.celllist import build_neighbor_list
from .forces import build_force_fn
from .simulate import resolve_device


def testforce_master(db, base_dir=".", *, device=None, dtype=torch.float32,
                     n_samples=8, h=1e-4, rel_tol=5e-3, verbose=True):
    """Returns (worst relative error, rows (particle, axis, analytic,
    finite difference, relative error)); raises AssertionError when the
    worst error reaches rel_tol.  The particles are drawn with
    np.random.default_rng(0), the JAX master's draw."""
    sd = build_system(db, base_dir, dtype=dtype,
                      device=resolve_device(device))
    grid = plan_grid(sd)
    force_fn = build_force_fn(sd, grid, dtype, "nlist")
    state, box = sd.state, sd.box

    nbr, _, overflow = build_neighbor_list(state.r, state.fmask, box.geom,
                                           grid, pbc=box.pbc)
    if bool(overflow):
        raise RuntimeError("neighbor overflow in testforce")
    f = force_fn(state, box, nbr)[0].cpu().numpy().astype(np.float64)

    def energy(i, ax, dx):
        r = state.r.clone()
        r[i, ax] += dx
        return float(force_fn(state.replace(r=r), box, nbr)[1])

    rng = np.random.default_rng(0)
    idxs = rng.integers(0, state.n_local, size=n_samples)
    worst = 0.0
    rows = []
    for i in idxs:
        for ax in range(3):
            fd = -(energy(i, ax, h) - energy(i, ax, -h)) / (2 * h)
            fa = f[i, ax]
            err = abs(fa - fd) / max(abs(fa), abs(fd), 1.0)
            worst = max(worst, err)
            rows.append((int(i), ax, fa, fd, err))
    if verbose:
        print(f"{'particle':>9} {'axis':>4} {'analytic':>16} "
              f"{'finite-diff':>16} {'rel err':>10}")
        for i, ax, fa, fd, err in rows:
            print(f"{i:>9d} {ax:>4d} {fa:16.8f} {fd:16.8f} {err:10.2e}")
        print(f"worst relative error: {worst:.3e} (tol {rel_tol})")
    if worst >= rel_tol:
        raise AssertionError(f"force test failed: {worst} >= {rel_tol}")
    return worst, rows
