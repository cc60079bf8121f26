"""PAIRENERGY potential: polynomial-series pair interaction.

Counterpart of ddcmd_tpu/potentials/pairenergy.py (reference ddcMD
src/pairEnergy.c, parameterised by pairfs_parms, the series scheme of
EAM FS SERIES mode, src/eam_fs.c:86-140):

  deck: rmax=..; r_expansion=..;  <A>-<B>_2body = c0 c1 c2 ... (eV, with
        c_l multiplying alpha^l, alpha = 1/Ang^2);
  energy per pair: e(r) = sum_l c_l y^l,  y = r_expansion^2 - r^2
  (dv/dr)/r = -2 sum_l l c_l y^(l-1)

compile_pairenergy is host numpy, copied from the JAX package; the
series runs over the (N,K) neighbor list (nbr/celllist.py) in plain
PyTorch, as the JAX package runs it in plain XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import nearest_image_pbc
from ..objects import DeckError, ObjectDB
from ..objects import units as U


@dataclass
class PairEnergyParms:
    n_species: int
    coeffs: np.ndarray      # (T*T, n_c) internal units (y in nm^2)
    r2_expansion: float
    rcut: float


def compile_pairenergy(db: ObjectDB, name: str, species) -> PairEnergyParms:
    pot = db.get(name, "POTENTIAL")
    rmax = pot.get_with_units("rmax", "0.0", "Angstrom")
    if rmax <= 0:
        raise DeckError(f"{name}: PAIRENERGY requires rmax")
    r_exp = pot.get_with_units("r_expansion", "3.0", "Angstrom")
    ns = len(species)
    eV = U.unit_scale("eV")
    alpha = 1.0 / U.unit_scale("Angstrom") ** 2  # per Ang^2 -> per nm^2
    n_c = 0
    raw = {}
    for i, si in enumerate(species):
        for j in range(i, ns):
            sj = species[j]
            key = f"{si.name}-{sj.name}_2body"
            if not pot.has(key):
                key = f"{sj.name}-{si.name}_2body"
            vals = pot.get_floatv(key) if pot.has(key) else []
            raw[(i, j)] = vals
            n_c = max(n_c, len(vals))
    if n_c == 0:
        raise DeckError(f"{name}: no <A>-<B>_2body series found")
    coeffs = np.zeros((ns * ns, n_c))
    for (i, j), vals in raw.items():
        scale = eV
        for l, v in enumerate(vals):
            coeffs[i * ns + j, l] = v * scale
            coeffs[j * ns + i, l] = v * scale
            scale *= alpha
    return PairEnergyParms(n_species=ns, coeffs=coeffs,
                           r2_expansion=r_exp * r_exp, rcut=rmax)


def pairenergy_device_tables(parms, dtype=torch.float32, device="cpu"):
    """The series coefficients on the device; r2e and rcut2 stay host
    floats rounded as `dtype` rounds them.  `parms` may come from either
    package's compile_pairenergy."""
    def scalar(x):
        return float(torch.tensor(x, dtype=dtype))

    return dict(coeffs=torch.as_tensor(np.asarray(parms.coeffs), dtype=dtype,
                                       device=device),
                r2e=scalar(parms.r2_expansion), rcut2=scalar(parms.rcut ** 2),
                n_species=parms.n_species)


def pairenergy_eval(r, sidx, fmask, nbr_idx, geom, tables, pbc_mask=None):
    """The series pair potential over the full (N,K) list; pbc_mask as in
    martini_nonbond.  Returns (f, e, virial, pe)."""
    sentinel = r.shape[0]
    T = tables["n_species"]
    C = tables["coeffs"]            # (T*T, n_c)
    n_c = C.shape[1]

    r_ext = torch.cat([r, r.new_zeros((1, 3))], dim=0)
    s_ext = torch.cat([sidx, sidx.new_zeros((1,))], dim=0)
    dr = nearest_image_pbc(r[:, None, :] - r_ext[nbr_idx], geom, pbc_mask)
    r2 = torch.sum(dr * dr, dim=-1)
    valid = ((nbr_idx != sentinel) & (r2 < tables["rcut2"]) & (r2 > 0)
             & (fmask[:, None] > 0))
    w = valid.to(r.dtype)
    y = tables["r2e"] - r2

    Cp = C[sidx[:, None] * T + s_ext[nbr_idx]]      # (N, K, n_c)
    # Horner over l
    e = Cp[..., n_c - 1]
    for l in range(n_c - 2, -1, -1):
        e = e * y + Cp[..., l]
    dpoly = torch.zeros_like(e)     # sum_l l c_l y^(l-1)
    for l in range(n_c - 1, 0, -1):
        dpoly = dpoly * y + l * Cp[..., l]
    e_pair = e * w
    dvdr = -2.0 * dpoly * w          # de/dr / r  (y = r2e - r^2)

    fij = -dvdr[:, :, None] * dr
    f = torch.sum(fij, dim=1)
    pe = 0.5 * torch.sum(e_pair, dim=1)
    virial = 0.5 * torch.einsum("nka,nkb->ab", fij, dr)
    return f, pe.sum(), virial, pe
