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

The pair sums run in the cell-pair kernels (ops/cellpair_half.py), in
the plain cell-block engine (ops/cellpair.py) or over the (N,K) list
(martini_nonbond); this module compiles the host tables, moves them to
the device and holds the list form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import nearest_image_pbc
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


def martini_nonbond(r, q, tidx, fmask, nbr_idx, geom, tables,
                    excl_tbl=None, pbc_mask=None, n_rows=None):
    """Forces, energy and virial over the full (N,K) neighbor list.

    r: (N,3) wrapped positions; q: (N,) charges; tidx: (N,) LJ type;
    fmask: (N,) 1.0 for valid particles; nbr_idx: (N,K) full list,
    sentinel N; geom: (3,) lengths or a (3,3) h; tables:
    martini_device_tables().  excl_tbl: optional (N, Emax) per-particle
    excluded-partner rows (sentinel N): excluded pairs are dropped from
    the list here, never computed and subtracted, and the bonded block
    runs its exclusion term in "rf_add" mode to restore the
    reaction-field part the reference keeps for them
    (bioMartini.c:1124-1208).  pbc_mask: Box.pbc_mask on a box with a
    non-periodic axis (the minimum image on the periodic axes only).
    n_rows: nbr_idx holds the rows of the first n_rows particles only
    (the brick list engine's local rows; the others are neighbours), and
    f and pe have n_rows rows.
    Returns (f (N,3), e_pot, virial (3,3), pe (N,), (e_lj, e_ele))."""
    sentinel = r.shape[0]
    n_i = sentinel if n_rows is None else n_rows
    ri, q_i, t_i, fm_i = r[:n_i], q[:n_i], tidx[:n_i], fmask[:n_i]
    r_ext = torch.cat([r, r.new_zeros((1, 3))], dim=0)
    q_ext = torch.cat([q, q.new_zeros((1,))], dim=0)
    t_ext = torch.cat([tidx, tidx.new_zeros((1,))], dim=0)

    # orthorhombic boxes keep the displacements per component, (N,K) each
    ortho = geom.dim() == 1
    if ortho:
        d_c = []
        r2 = torch.zeros(nbr_idx.shape, dtype=r.dtype, device=r.device)
        for c in range(3):
            dc = nearest_image_pbc(
                ri[:, c][:, None] - r_ext[:, c][nbr_idx], geom[c:c + 1],
                None if pbc_mask is None else pbc_mask[c:c + 1])
            d_c.append(dc)
            r2 = r2 + dc * dc
    else:
        dr = nearest_image_pbc(ri[:, None, :] - r_ext[nbr_idx], geom,
                               pbc_mask)
        r2 = torch.sum(dr * dr, dim=-1)

    pair_t = t_i[:, None] * tables["sigma"].shape[0] + t_ext[nbr_idx]
    sig = tables["sigma"].reshape(-1)[pair_t]
    eps = tables["eps"].reshape(-1)[pair_t]
    shf = tables["shift"].reshape(-1)[pair_t]

    valid = (nbr_idx != sentinel) & (r2 < tables["rcut2"]) & (r2 > 0)
    valid = valid & (fm_i[:, None] > 0)
    if excl_tbl is not None:
        excluded = torch.any(nbr_idx[:, :, None] == excl_tbl[:, None, :],
                             dim=-1)
        valid = valid & ~excluded
    r2s = torch.where(valid, r2, 1.0)
    ir2 = 1.0 / r2s
    ir = torch.sqrt(ir2)

    s2 = sig * sig * ir2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e_lj_pair = 4.0 * eps * (s12 - s6) + shf
    dvdr = 24.0 * eps * (s6 - 2.0 * s12) * ir2                # (dv/dr)/r

    kqq = tables["keR"] * q_i[:, None] * q_ext[nbr_idx]
    e_ele_pair = kqq * (ir + tables["krf"] * r2s - tables["crf"])
    dvdr = dvdr + kqq * (2.0 * tables["krf"] - ir2 * ir)

    w = valid.to(r.dtype)
    coef = -(dvdr * w)
    if ortho:
        f = torch.stack([torch.sum(coef * d_c[c], dim=1) for c in range(3)],
                        dim=1)
        virial = 0.5 * torch.stack([
            torch.stack([torch.sum(coef * d_c[a] * d_c[b])
                         for b in range(3)]) for a in range(3)])
    else:
        fij = coef[:, :, None] * dr
        f = torch.sum(fij, dim=1)
        # virial_ab = 0.5 sum_pairs f_ij,a dr_ij,b (both sides counted)
        virial = 0.5 * torch.einsum("nka,nkb->ab", fij, dr)

    # per-particle energy: half of each pair + the own self term
    # (bioMartini.c:1035)
    e_self_i = -0.5 * q_i * q_i * fm_i * tables["keR"] * tables["crf"]
    pe = 0.5 * torch.sum((e_lj_pair + e_ele_pair) * w, dim=1) + e_self_i
    e_lj = 0.5 * torch.sum(e_lj_pair * w)
    e_ele = 0.5 * torch.sum(e_ele_pair * w) + torch.sum(e_self_i)
    return f, e_lj + e_ele, virial, pe, (e_lj, e_ele)
