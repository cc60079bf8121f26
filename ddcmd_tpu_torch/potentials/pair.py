"""PAIR potential: shifted Lennard-Jones or tabulated pair between SPECIES
(reference ddcMD src/pair.c:44-322).

Counterpart of ddcmd_tpu/potentials/pair.py.  Deck forms:

    pot POTENTIAL { type=PAIR; function=lennardjones; cutoff=...;
                    eps=...; sigma=...; }        (one pair for all species)
    A-B PAIRPARMS { eps=...; sigma=...; }        (per species pair)

Energy: v = 4 eps ((s/r)^12 - (s/r)^6) - v(rc)  (shift=1, the default).

function=TableFunction parses a piecewise-polynomial table
(table_function_uniform, src/table_function.c:28-101): rows
`x a0 a1 ... a_{terms-1}` on uniform intervals, v(r) = sum a_k (r-x_i)^k.
The port evaluates LJ only, on the cell-pair kernels with Coulomb off; a
table is evaluated by the JAX package's (N,K)-list engine only
(pair_lj), which the port does not have yet (ROADMAP queue 1, item 19),
so every engine of the port raises for it.

compile_pair is host numpy, copied from the JAX package (importing
ddcmd_tpu imports jax).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..objects import DeckError, ObjectDB
from ..objects import units as U

TABLE_ITEM = ("PAIR function=TableFunction: the table is evaluated only by "
              "the JAX package's (N,K)-list engine (pair_lj), not ported "
              "yet (ROADMAP queue 1, item 19)")


@dataclass
class PairParms:
    n_species: int
    sigma: np.ndarray
    eps: np.ndarray
    shift: np.ndarray
    rcut: float
    # TableFunction variant (None for LJ)
    table: dict | None = None


def compile_pair(db: ObjectDB, name: str, species,
                 base_dir: str = ".") -> PairParms:
    pot = db.get(name, "POTENTIAL")
    func = pot.get_str("function", "lennardjones").lower()
    if func == "tablefunction":
        n_iv = pot.get_int("number_intervals", 1)
        n_terms = pot.get_int("number_terms", 1)
        fname = pot.get_str("filename", "table.data")
        e_conv = U.unit_scale(pot.get_str("table_energyUnits", "energy"))
        l_conv = U.unit_scale(pot.get_str("table_lengthUnits", "l"))
        rmax = pot.get_with_units("Rmax", "0.0", "l")
        rows = np.loadtxt(os.path.join(base_dir, fname),
                          ndmin=2)[:n_iv, : n_terms + 1]
        x = rows[:, 0] * l_conv
        coeff = rows[:, 1:] * (e_conv / l_conv ** np.arange(n_terms))
        dx = np.diff(x)
        if len(dx) and abs(1.0 - dx.mean() ** 2 / (dx ** 2).mean()) > 1e-12:
            raise DeckError(f"{name}: TableFunction requires uniform "
                            "intervals (as table_function_uniform)")
        ns = len(species)
        table = dict(x0=x[0], dx=float(dx.mean()) if len(dx) else 1.0,
                     x=x, coeff=coeff, rmax=rmax)
        return PairParms(n_species=ns, sigma=np.zeros((ns, ns)),
                         eps=np.zeros((ns, ns)), shift=np.zeros((ns, ns)),
                         rcut=rmax, table=table)
    rcut = pot.get_with_units("cutoff", "0.0", "l")
    if rcut <= 0:
        raise DeckError(f"{name}: PAIR requires cutoff")
    ns = len(species)
    sigma = np.zeros((ns, ns))
    eps = np.zeros((ns, ns))
    found_any = False
    for i, si in enumerate(species):
        for j, sj in enumerate(species[: i + 1]):
            obj = (db.find(f"{si.name}-{sj.name}", None)
                   or db.find(f"{sj.name}-{si.name}", None))
            if obj is not None and obj.objclass.endswith("PARMS"):
                s = obj.get_with_units("sigma", "0.0", "l")
                e = obj.get_with_units("eps", "0.0", "energy")
                sigma[i, j] = sigma[j, i] = s
                eps[i, j] = eps[j, i] = e
                found_any = True
    if not found_any:
        s = pot.get_with_units("sigma", "0.0", "l")
        e = pot.get_with_units("eps", "0.0", "energy")
        if s <= 0:
            raise DeckError(f"{name}: no pair parameters found")
        sigma[:] = s
        eps[:] = e
    do_shift = pot.get_int("shift", 1)
    sr6 = np.where(sigma > 0, (sigma / rcut) ** 6, 0.0)
    shift = -4.0 * eps * (sr6 ** 2 - sr6) if do_shift else np.zeros_like(eps)
    return PairParms(n_species=ns, sigma=sigma, eps=eps, shift=shift,
                     rcut=rcut)


def pair_device_tables(parms, dtype=torch.float32, device="cpu"):
    """The pair engines' tables: sigma, eps, shift (T,T) on the device and
    the host scalars rcut2 and krf = crf = keR = 0 (the Coulomb-off
    shifted LJ of the MARTINI tables, ops/cellpair_half.kernel_inputs),
    rounded as `dtype` rounds them.  `parms` may come from either
    package's compile_pair (its fields are numpy arrays).  A
    TableFunction raises (ROADMAP queue 1, item 19)."""
    if parms.table is not None:
        raise NotImplementedError(TABLE_ITEM)

    def scalar(x):
        return float(torch.tensor(x, dtype=dtype))

    return dict(
        sigma=torch.as_tensor(np.asarray(parms.sigma), dtype=dtype,
                              device=device),
        eps=torch.as_tensor(np.asarray(parms.eps), dtype=dtype,
                            device=device),
        shift=torch.as_tensor(np.asarray(parms.shift), dtype=dtype,
                              device=device),
        rcut2=scalar(parms.rcut ** 2), krf=0.0, crf=0.0, keR=0.0)
