"""MARTINI coarse-grained force field: parameter compilation + tables.

Counterpart of ddcmd_tpu/potentials/martini.py.  Nonbond physics
(martiniNonBond, ddcMD src/bioMartini.c:989-1120):

  * shifted LJ:  v += 4 eps ((sigma/r)^12 - (sigma/r)^6) + shift,
    shift = -4 eps ((sigma/rc)^12 - (sigma/rc)^6)
    (CGLennardJones_setShift, bioMartini.c:840-848)
  * reaction-field Coulomb:
    v += (ke/eps_r) qi qj (1/r + krf r^2 - crf),
    krf = (eps_rf - eps_r) / ((2 eps_rf + eps_r) rc^3),
    crf = 3 eps_rf / ((2 eps_rf + eps_r) rc);  eps_rf = -1 means
    eps_rf -> inf: krf = 1/(2 rc^3), crf = 3/(2 rc)
    (bioMartini.c:1238-1243)
  * self energy: -0.5 sum q^2 (ke/eps_r) crf (bioMartini.c:1035)

The pair sums themselves run in the cell-pair kernel
(ops/cellpair_half.py); this module compiles the host tables and moves
them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..objects import ObjectDB
from ..objects import units as U


@dataclass
class MartiniParms:
    """Compiled MMFF nonbond tables (host)."""

    n_types: int
    sigma: np.ndarray       # (T,T)
    eps: np.ndarray         # (T,T)
    shift: np.ndarray       # (T,T)
    rcut: float
    rcoulomb: float
    epsilon_r: float
    epsilon_rf: float
    krf: float
    crf: float
    type_names: list[str]
    # species-name -> LJ type index (from ATOMPARMS atomTypeID)
    species_to_type: dict[str, int]


def compile_martini(db: ObjectDB, potential_name: str = "martini") -> MartiniParms:
    """Build nonbond tables from the MMFF object tree
    (mmff_init + martiniLJ_parms, ddcMD src/bioMartini.c:869-955,1210-1246)."""
    pot = db.get(potential_name, "POTENTIAL")
    mmff = db.get(potential_name, "MMFF")

    atom_types = mmff.get_strv("atomTypeList")
    n_types = len(atom_types)

    cutoff = pot.get_with_units("cutoff", "11.0", "Angstrom")
    rcoulomb = pot.get_with_units("rcoulomb", "11.0", "Angstrom")
    epsilon_r = pot.get_float("epsilon_r", 15.0)
    epsilon_rf = pot.get_float("epsilon_rf", -1.0)
    potential_shift = pot.get_int("potential-shift", 1)

    irc = 1.0 / rcoulomb
    irc3 = irc ** 3
    if epsilon_rf != -1.0:
        krf = (epsilon_rf - epsilon_r) / (2 * epsilon_rf + epsilon_r) * irc3
        crf = 3 * epsilon_rf / (2 * epsilon_rf + epsilon_r) * irc
    else:
        krf = 0.5 * irc3
        crf = 1.5 * irc

    sigma = np.zeros((n_types, n_types))
    eps = np.zeros((n_types, n_types))
    for lj_name in mmff.get_strv("ljParms"):
        lj = db.get(lj_name, "LJPARMS")
        i = lj.get_int("indexI")
        j = lj.get_int("indexJ")
        s = lj.get_with_units("sigma", "0.0", "l")
        e = lj.get_with_units("eps", "0.0", "energy")
        sigma[i, j] = sigma[j, i] = s
        eps[i, j] = eps[j, i] = e

    sr = np.divide(sigma, cutoff)
    s6 = sr ** 6
    shift = -4.0 * eps * (s6 * s6 - s6) if potential_shift else np.zeros_like(eps)

    # species name -> LJ type index via RESIPARMS/GROUPPARMS/ATOMPARMS.
    # ddcMD species for bio systems are named <atomName>x<resName> (e.g.
    # WxW = atom W of residue W); getCGLJindexbySpecie
    # (ddcMD src/bioMartini.c:957-988) resolves by splitting on 'x'.
    species_to_type: dict[str, int] = {}
    for resi_name in mmff.get_strv("resiParms"):
        resi = db.get(resi_name, "RESIPARMS")
        res_name = resi.get_str("resName", resi_name)
        for grp_name in resi.get_strv("groupList"):
            grp = db.get(grp_name, "GROUPPARMS")
            for atom_entry in grp.get_strv("atomList"):
                ap = db.get(atom_entry, "ATOMPARMS")
                atom_name = ap.get_str("atomName")
                tindex = ap.get_int("atomTypeID")
                species_to_type[f"{atom_name}x{res_name}"] = tindex

    return MartiniParms(
        n_types=n_types, sigma=sigma, eps=eps, shift=shift,
        rcut=cutoff, rcoulomb=rcoulomb,
        epsilon_r=epsilon_r, epsilon_rf=epsilon_rf, krf=krf, crf=crf,
        type_names=atom_types, species_to_type=species_to_type,
    )


def martini_device_tables(parms: MartiniParms, dtype=torch.float32,
                          device="cpu"):
    """(T,T) parameter tensors on the device; the scalars stay host
    floats rounded as `dtype` rounds them (the kernel takes them as launch
    arguments, so reading them never synchronises with the device)."""
    def scalar(x):
        return float(torch.tensor(x, dtype=dtype))

    return dict(
        sigma=torch.as_tensor(parms.sigma, dtype=dtype, device=device),
        eps=torch.as_tensor(parms.eps, dtype=dtype, device=device),
        shift=torch.as_tensor(parms.shift, dtype=dtype, device=device),
        rcut2=scalar(parms.rcut ** 2),
        krf=scalar(parms.krf),
        crf=scalar(parms.crf),
        keR=scalar(U.ke / parms.epsilon_r),
    )
