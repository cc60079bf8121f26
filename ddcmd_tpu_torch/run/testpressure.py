"""testPressure master: virial pressure vs -dE/dV delta-convergence sweep.

Counterpart of ddcmd_tpu/run/testpressure.py (reference
testPressureMaster, ddcMD src/masters.c:134-202).  For each box axis it
halves a relative strain delta `n_halvings` times, evaluates the energy
at (1 +- delta) along that axis, compares the central difference -dE/dV
with the virial's diagonal component, and writes pressure{ax}.data;
_check_quadratic asserts the error shows the ~delta^2 truncation regime
(or converges deeply) instead of a flat offset, which would be a virial
bug.  A second sweep scales the molecules' centres of mass rigidly and
checks the molecular virial (molecularPressure.c:22-67), the pressure
the NGLFCONSTRAINT barostat reads; it writes pressureMol{ax}.data.  On
the (N,K)-list engine, in the dtype asked for (the CLI runs f64: at f32
the central difference hits roundoff after ~3 halvings).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.molecule import build_molecule_class, make_molecular_virial_fn
from ..core.system import build_system, plan_grid
from ..nbr.celllist import build_neighbor_list
from .forces import build_force_fn
from .simulate import resolve_device


def _sweep(energy_at, p_virial, vol, delta0, n_halvings):
    """Central-difference -dE/dV at shrinking deltas vs a fixed virial P:
    rows [(delta, p_fd, |p_fd - p_virial|)]."""
    rows = []
    delta = delta0
    for _ in range(n_halvings + 1):
        ep = energy_at(1.0 + delta)
        em = energy_at(1.0 - delta)
        p_fd = -(ep - em) / (2.0 * delta * vol)
        rows.append((delta, p_fd, abs(p_fd - p_virial)))
        delta *= 0.5
    return rows


def _check_quadratic(rows, axis, what, p_vir=None):
    """Assert the sweep converges like a truncation error, not a bug:
    either (a) at least two halving ratios in [2.8, 5.5] while the
    error is clearly above the roundoff floor (C delta^2 divides by ~4
    a halving), or (b) the error converges deeply (min < 1e-5 of the
    pressure scale), as it does for potentials cut but not force-shifted
    once no pair crosses the cutoff within [1 - delta, 1 + delta].  A
    wrong virial plateaus at its offset and fails both."""
    errs = [r[2] for r in rows]
    floor = max(min(errs), 1e-300)
    ratios = []
    for k in range(len(errs) - 1):
        # only trust ratios while clearly above the noise floor
        if errs[k] > 50.0 * floor and errs[k + 1] > 10.0 * floor:
            ratios.append(errs[k] / errs[k + 1])
    good = sum(1 for q in ratios if 2.8 <= q <= 5.5)
    scale = max(abs(p_vir) if p_vir is not None else 0.0,
                max(errs), 1e-300)
    converged = min(errs) < 1e-5 * scale
    if not (good >= 2 or converged):
        raise AssertionError(
            f"{what} axis {axis}: no delta^2 convergence regime "
            f"(halving ratios {['%.2f' % q for q in ratios]}, "
            f"min err {min(errs):.3e} vs scale {scale:.3e}) — "
            f"the virial disagrees with -dE/dV beyond truncation error")


def _write_table(path, head, cols, p_vir, rows):
    with open(path, "w") as fh:
        fh.write(head)
        fh.write(cols)
        for d, p_fd, err in rows:
            rel = err / max(abs(p_vir), 1e-300)
            fh.write(f"{d:.6e} {p_fd:.15e} {err:.6e} {rel:.6e}\n")


def testpressure_master(db, base_dir=".", *, device=None,
                        dtype=torch.float64, delta0=2e-2, n_halvings=10,
                        out_dir=None, check_slope=True, verbose=True):
    """Run the per-axis delta sweeps; write pressure{ax}.data (and
    pressureMol{ax}.data for a deck with molecules) into out_dir (the
    deck's directory by default).  Returns {"atomic": [(axis, P_virial,
    rows)], "molecular": [...] or None}."""
    dev = resolve_device(device)
    sd = build_system(db, base_dir, dtype=dtype, device=dev)
    grid = plan_grid(sd)
    force_fn = build_force_fn(sd, grid, dtype, "nlist")
    state, box = sd.state, sd.box
    out_dir = base_dir if out_dir is None else out_dir

    def evaluate(st, lam):
        box_s = box.scale(torch.as_tensor(lam, dtype=dtype, device=dev))
        nbr, _, ov = build_neighbor_list(st.r, st.fmask, box_s.geom, grid,
                                         pbc=box_s.pbc)
        if bool(ov):
            raise RuntimeError("neighbor capacity overflow during volume "
                               "scan")
        return force_fn(st, box_s, nbr)

    def energy_atomic(lam):
        lam_t = torch.as_tensor(lam, dtype=dtype, device=dev)
        return float(evaluate(state.replace(r=state.r * lam_t[None, :]),
                              lam)[1])

    f0, _, virial0, _ = evaluate(state, np.ones(3))
    virial0 = virial0.cpu().numpy().astype(np.float64)
    vol = float(box.volume)

    sysobj = db.get(sd.cfg.system_name, "SYSTEM")
    mols = build_molecule_class(db, sysobj, sd.collection.species_names,
                                sd.collection.gid)
    mol_fn = make_molecular_virial_fn(mols, dtype=dtype, device=dev)
    results = {"atomic": [], "molecular": [] if mol_fn is not None else None}

    def axis_lam(ax, s):
        lam = np.ones(3)
        lam[ax] = s
        return lam

    for ax in range(3):
        p_vir = virial0[ax, ax] / vol
        rows = _sweep(lambda s, _ax=ax: energy_atomic(axis_lam(_ax, s)),
                      p_vir, vol, delta0, n_halvings)
        results["atomic"].append((ax, p_vir, rows))
        _write_table(os.path.join(out_dir, f"pressure{ax}.data"),
                     f"# axis {ax}: P_virial = {p_vir:.15e} (internal "
                     "units)\n", "# delta  P_fd(-dE/dV)  abs_err  rel_err\n",
                     p_vir, rows)
        if verbose:
            best = min(r[2] for r in rows)
            print(f"axis {ax}: P_virial={p_vir:.10e} best_err={best:.3e}")
        if check_slope:
            _check_quadratic(rows, ax, "atomic virial", p_vir)

    if mol_fn is None:
        return results
    # -dE/dV under rigid-molecule scaling: the centres of mass scale with
    # the box, the internal geometry is frozen; that derivative equals
    # the molecular-virial pressure (molecularPressure.c:22-67)
    rows_np = mols.atom_rows                        # (M, A)
    amask = mols.atom_mask                          # (M, A)
    L0 = box.lengths.cpu().numpy().astype(np.float64)
    r0 = state.r.cpu().numpy().astype(np.float64)
    m0 = state.mass.cpu().numpy().astype(np.float64)
    r_m = r0[rows_np]                               # (M, A, 3)
    r_own = r_m[np.arange(len(rows_np)), mols.owner_offset]
    d = r_m - r_own[:, None, :]
    d -= L0 * np.round(d / L0)
    mm = m0[rows_np] * amask
    com = (mm[:, :, None] * d).sum(1) / mm.sum(1)[:, None] + r_own
    mvir = mol_fn(state.replace(f=f0), box,
                  torch.as_tensor(virial0, dtype=dtype, device=dev))
    mvir = mvir.cpu().numpy().astype(np.float64)

    def energy_molecular(ax, s):
        lam = axis_lam(ax, s)
        r_new = r0.copy()
        shift = com * (lam - 1.0)                   # (M, 3)
        np.add.at(r_new, rows_np.reshape(-1),
                  np.repeat(shift, rows_np.shape[1], axis=0)
                  * amask.reshape(-1, 1))
        st = state.replace(r=torch.as_tensor(r_new, dtype=dtype, device=dev))
        return float(evaluate(st, lam)[1])

    for ax in range(3):
        p_vir = mvir[ax, ax] / vol
        rows = _sweep(lambda s, _ax=ax: energy_molecular(_ax, s), p_vir, vol,
                      delta0, n_halvings)
        results["molecular"].append((ax, p_vir, rows))
        _write_table(os.path.join(out_dir, f"pressureMol{ax}.data"),
                     f"# axis {ax}: P_molvirial = {p_vir:.15e}\n",
                     "# delta  P_fd(-dE/dV|rigid)  abs_err  rel_err\n",
                     p_vir, rows)
        if verbose:
            best = min(r[2] for r in rows)
            print(f"mol axis {ax}: P={p_vir:.10e} best_err={best:.3e}")
        if check_slope:
            _check_quadratic(rows, ax, "molecular virial", p_vir)
    return results
