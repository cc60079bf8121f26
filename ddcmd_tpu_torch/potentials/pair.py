"""PAIR potential: shifted Lennard-Jones or tabulated pair between SPECIES
(reference ddcMD src/pair.c:44-322).

Counterpart of ddcmd_tpu/potentials/pair.py.  Deck forms:

    pot POTENTIAL { type=PAIR; function=lennardjones; cutoff=...;
                    eps=...; sigma=...; }        (one pair for all species)
    A-B PAIRPARMS { eps=...; sigma=...; }        (per species pair)

Energy: v = 4 eps ((s/r)^12 - (s/r)^6) - v(rc)  (shift=1, the default).

function=TableFunction parses a piecewise-polynomial table
(table_function_uniform, src/table_function.c:28-101): rows
`x a0 a1 ... a_{terms-1}` on uniform intervals, v(r) = sum a_k (r-x_i)^k,
dv/dr = sum k a_k (r-x_i)^{k-1}.

Lennard-Jones runs on the cell-pair kernels (Coulomb off) or the plain
cell-block engine, and on the (N,K)-list engine through pair_lj.  A table
is evaluated by pair_lj only, as in the JAX package, whose cell engines
give such a deck zero pair force; the port's cell engines raise for it
(TABLE_ENGINE), and the mesh runs it on its brick list engine.

compile_pair is host numpy, copied from the JAX package (importing
ddcmd_tpu imports jax).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import nearest_image_pbc
from ..objects import DeckError, ObjectDB
from ..objects import units as U

TABLE_ENGINE = ("PAIR function=TableFunction: the table is evaluated only "
                "on the (N,K)-list engine (pair_lj); run the deck with "
                'engine="nlist" (the JAX package\'s cell engines give it '
                "zero pair force)")


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
    rounded as `dtype` rounds them; a TableFunction adds its rows tab_x
    (m,) and tab_coeff (m, terms) on the device and the host scalars
    tab_x0 and tab_idx (1/dx).  `parms` may come from either package's
    compile_pair (its fields are numpy arrays)."""
    def scalar(x):
        return float(torch.tensor(x, dtype=dtype))

    def ten(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    t = dict(sigma=ten(parms.sigma), eps=ten(parms.eps),
             shift=ten(parms.shift), rcut2=scalar(parms.rcut ** 2), krf=0.0,
             crf=0.0, keR=0.0)
    if parms.table is not None:
        tb = parms.table
        t.update(tab_x=ten(tb["x"]), tab_coeff=ten(tb["coeff"]),
                 tab_x0=scalar(tb["x0"]), tab_idx=scalar(1.0 / tb["dx"]))
    return t


def pair_lj(r, sidx, fmask, nbr_idx, geom, tables, pbc_mask=None,
            n_rows=None):
    """Shifted LJ, or the TableFunction's piecewise polynomial, over the
    full (N,K) neighbor list; pbc_mask and n_rows as in martini_nonbond.
    Returns (f, e, virial, pe)."""
    sentinel = r.shape[0]
    n_i = sentinel if n_rows is None else n_rows
    r_ext = torch.cat([r, r.new_zeros((1, 3))], dim=0)
    s_ext = torch.cat([sidx, sidx.new_zeros((1,))], dim=0)

    dr = nearest_image_pbc(r[:n_i, None, :] - r_ext[nbr_idx], geom,
                           pbc_mask)
    r2 = torch.sum(dr * dr, dim=-1)

    valid = ((nbr_idx != sentinel) & (r2 < tables["rcut2"]) & (r2 > 0)
             & (fmask[:n_i, None] > 0))
    r2s = torch.where(valid, r2, 1.0)
    ir2 = 1.0 / r2s
    if "tab_coeff" in tables:
        # piecewise polynomial in (r - x_i) (table_function_uniform,
        # table_function.c:85-101); dvdr here is (dv/dr)/r
        rr = torch.sqrt(r2s)
        i = torch.clamp(((rr - tables["tab_x0"]) * tables["tab_idx"]).long(),
                        0, tables["tab_x"].shape[0] - 1)
        xr = rr - tables["tab_x"][i]
        c = tables["tab_coeff"][i]          # (N, K, terms)
        K = c.shape[-1]
        v = c[..., K - 1]
        d = torch.zeros_like(v)
        for k in range(K - 2, -1, -1):
            d = d * xr + (k + 1) * c[..., k + 1]
            v = v * xr + c[..., k]
        e_pair = v
        dvdr = d / rr
    else:
        ns = tables["sigma"].shape[0]
        pair_t = sidx[:n_i, None] * ns + s_ext[nbr_idx]
        sig = tables["sigma"].reshape(-1)[pair_t]
        eps = tables["eps"].reshape(-1)[pair_t]
        shf = tables["shift"].reshape(-1)[pair_t]
        s2 = sig * sig * ir2
        s6 = s2 * s2 * s2
        s12 = s6 * s6
        e_pair = 4.0 * eps * (s12 - s6) + shf
        dvdr = 24.0 * eps * (s6 - 2.0 * s12) * ir2

    w = valid.to(r.dtype)
    fij = -(dvdr * w)[:, :, None] * dr
    f = torch.sum(fij, dim=1)
    pe = 0.5 * torch.sum(e_pair * w, dim=1)
    virial = 0.5 * torch.einsum("nka,nkb->ab", fij, dr)
    return f, pe.sum(), virial, pe
