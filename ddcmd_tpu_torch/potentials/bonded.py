"""Bonded (covalent) topology, the device term tables and the generic
per-term evaluator.

Counterpart of ddcmd_tpu/potentials/bonded.py.  Host part (copies of the
JAX package's host code): residue templates compiled from the MMFF
RESIPARMS trees (`compile_residue_types`; CHARMM's come from
potentials/charmm.py), particles matched to residue instances
(`scan_residues`), the templates expanded over the instances
(`instantiate_bonded`), and the term tables moved to the device
(`device_bonded_tables`).  Device part: the per-family term math
(`bond_term` ... `excl_rf_term`), shared by the residue-template batched
evaluator (potentials/bonded_batch.py) and by `bonded_eval`, the generic
gather / index_add_ evaluator of the terms that batch does not take
(CHARMM junction terms across residue instances, CMAP).

Forms (ddcMD src/bioCharmmCovalentEnergiesSorted.c):

  bond (func 1):      e = kb (b - b0)^2              (CHARMM convention, no 1/2)
  angle (func 1):     e = ktheta (theta - theta0)^2, theta0 raw radians
  angle cos (func 2): e = ktheta (cosA - theta0)^2, theta0 raw cosine
  angle REB (func 10):e = ktheta (cosA - theta0)^2 / sin^2 A
  torsion:            e = kchi (1 + cos(n phi - delta))
  improper (CHARMM):  e = kpsi (psi - psi0)^2 wrapped to [-pi, pi]
  CMAP:               bicubic patch of the (phi, psi) grid
                      (bioCharmmCovalentEnergies.c:395-497)
  bpair:              shifted LJ with per-pair sigma/eps within the cutoff
                      (BpairLennardJones_setShift, bioMartini.c:850-866)
  exclusion:          excluded (bonded) pairs are masked in the pair
                      engine; the reaction-field polarization part the
                      reference keeps for them (martiniIntraMoleReaction,
                      bioMartini.c:1124-1208) is added back here:
                      e = keR qi qj (krf r^2 - crf) within the cutoff.

Torsions, impropers and CMAP take their forces by autograd of the summed
term energies (the JAX package's jax.vjp), not by a hand-derived force
decomposition.  Terms a weight switches off (the mesh's unowned
instances, the `<family>_w` weights) are evaluated on a fixed
non-degenerate geometry: their rows may coincide, and atan2(0, 0) or 1/0
would turn the zero weight's product into NaN.

The port never computes excluded pairs and subtracts them afterwards
(the JAX package's "subtract" mode): the f32 residual of a ~1e9 LJ wall
on a deeply compressed bond is an energy-injecting catapult.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import nearest_image
from ..objects import DeckError, ObjectDB


# ---------------------------------------------------------------------------
# compiled topology (host)
# ---------------------------------------------------------------------------

@dataclass
class ResidueType:
    name: str
    res_id: int
    atom_names: list[str]
    atom_types: list[int]
    charges: list[float]
    bonds: list[tuple]          # (i, j, kb, b0)
    angles_h: list[tuple]       # (i, j, k, kt, t0)
    angles_cos: list[tuple]
    angles_reb: list[tuple]
    torsions: list[tuple]       # (i, j, k, l, kchi, n, delta)
    impropers: list[tuple]      # (i, j, k, l, kpsi, psi0)
    bpairs: list[tuple]         # (i, j, sigma, eps)
    cons_groups: list[list[tuple]]  # groups of (i, j, r0)
    exclusions: list[tuple]     # (i, j)
    # species names override (terminal-patched CHARMM variants use the
    # n/c delimiter instead of x<name>); None = <atom>x<name>
    species_sig: list[str] | None = None


@dataclass
class BondedTerms:
    """Flat instantiated term arrays (host numpy; rows into State)."""

    bonds: np.ndarray = None          # (B,2) int32
    bond_parms: np.ndarray = None     # (B,2) kb,b0
    angles: np.ndarray = None         # (A,3)
    angle_parms: np.ndarray = None    # (A,2) kt,t0
    angle_kind: np.ndarray = None     # (A,) 0 harmonic, 1 cos, 2 reb
    torsions: np.ndarray = None       # (T,4)
    torsion_parms: np.ndarray = None  # (T,3) kchi,n,delta
    impropers: np.ndarray = None      # (I,4)
    improper_parms: np.ndarray = None  # (I,2) kpsi, psi0
    bpairs: np.ndarray = None         # (P,2)
    bpair_parms: np.ndarray = None    # (P,3) sigma, eps, shift
    exclusions: np.ndarray = None     # (E,2)
    # constraints: padded groups
    cons_atoms: np.ndarray = None     # (G, max_m) rows, pad=-1
    cons_pairs: np.ndarray = None     # (G, max_n, 2) local atom slots in group
    cons_dist: np.ndarray = None      # (G, max_n) r0, pad=0
    n_constraints: int = 0
    # CMAP phi/psi correction terms (charmm.add_chain_links)
    # instance i linked to i+1 (CHARMM inter-residue junctions); domain
    # decomposition keeps whole CHAINS device-coherent from this
    chain_links: np.ndarray = None    # (L,) int64
    cmap_atoms: np.ndarray = None     # (M,5) rows [-C, N, CA, C, +N]
    cmap_type: np.ndarray = None      # (M,)
    cmap_grid: np.ndarray = None      # (K, 24, 24) internal energy
    cmap_y1: np.ndarray = None        # d/dphi per node (deg^-1 scale)
    cmap_y2: np.ndarray = None
    cmap_y12: np.ndarray = None

    def counts(self):
        c = {}
        for k in ("bonds", "angles", "torsions", "impropers", "bpairs",
                  "exclusions", "cmap_atoms"):
            a = getattr(self, k)
            c["cmaps" if k == "cmap_atoms" else k] = 0 if a is None else len(a)
        c["cons_groups"] = 0 if self.cons_atoms is None else len(self.cons_atoms)
        c["n_constraints"] = self.n_constraints
        return c


def compile_residue_types(db: ObjectDB, mmff_name: str, cutoff: float) -> dict[str, ResidueType]:
    """Parse RESIPARMS trees (schema: ddcMD src/bioMMFF.c:53-220)."""
    mmff = db.get(mmff_name, "MMFF")
    out = {}
    for rp_name in mmff.get_strv("resiParms"):
        rp = db.get(rp_name, "RESIPARMS")
        res_name = rp.get_str("resName", rp_name)
        atom_names, atom_types, charges = [], [], []
        for g in rp.get_strv("groupList"):
            gp = db.get(g, "GROUPPARMS")
            for a in gp.get_strv("atomList"):
                ap = db.get(a, "ATOMPARMS")
                atom_names.append(ap.get_str("atomName"))
                atom_types.append(ap.get_int("atomTypeID"))
                charges.append(ap.get_with_units("charge", "0.0", "q"))
        bonds, angles_h, angles_cos, angles_reb = [], [], [], []
        torsions, impropers, bpairs, exclusions = [], [], [], []
        cons_groups = []
        for b in rp.get_strv("bondList"):
            bp = db.get(b, "BONDPARMS")
            bonds.append((bp.get_int("atomI"), bp.get_int("atomJ"),
                          bp.get_with_units("kb", "0.0", "kJ*mol^-1*nm^-2"),
                          bp.get_with_units("b0", "0.0", "nm")))
        for a in rp.get_strv("angleList"):
            ap = db.get(a, "ANGLEPARMS")
            tup = (ap.get_int("atomI"), ap.get_int("atomJ"), ap.get_int("atomK"),
                   ap.get_with_units("ktheta", "0.0", "kJ*mol^-1"),
                   ap.get_float("theta0", 0.0))
            func = ap.get_int("func", 1)
            if func == 1:
                angles_h.append(tup)
            elif func == 2:
                angles_cos.append(tup)
            elif func == 10:
                angles_reb.append(tup)
            else:
                raise DeckError(f"angle func {func} not supported")
        for t in rp.get_strv("dihedralList"):
            tp = db.get(t, "TORSPARMS")
            func = tp.get_int("func", 1)
            tup4 = (tp.get_int("atomI"), tp.get_int("atomJ"),
                    tp.get_int("atomK"), tp.get_int("atomL"))
            if func == 2:  # GROMACS improper harmonic
                impropers.append(tup4 + (
                    tp.get_with_units("kchi", "0.0", "kJ*mol^-1"),
                    tp.get_float("delta", 0.0)))
            else:
                torsions.append(tup4 + (
                    tp.get_with_units("kchi", "0.0", "kJ*mol^-1"),
                    tp.get_int("n", 1), tp.get_float("delta", 0.0)))
        for e in rp.get_strv("exclusionList"):
            ep = db.get(e, "EXCLUDEPARMS")
            exclusions.append((ep.get_int("atomI"), ep.get_int("atomJ")))
        for c in rp.get_strv("constraintList"):
            cl = db.get(c, "CONSLISTPARMS")
            grp = []
            for s in cl.get_strv("constraintSubList"):
                sp = db.get(s, "CONSPARMS")
                grp.append((sp.get_int("atomI"), sp.get_int("atomJ"),
                            sp.get_with_units("r0", "0.0", "nm")))
            if grp:
                cons_groups.append(grp)
        # bonded LJ pairs ("pairList" in MMFF decks)
        for p in rp.get_strv("pairList"):
            pp = db.get(p, "BPAIRPARMS") or db.get(p, "PAIRPARMS")
            bpairs.append((pp.get_int("atomI"), pp.get_int("atomJ"),
                           pp.get_with_units("sigma", "0.0", "l"),
                           pp.get_with_units("eps", "0.0", "energy")))
        out[res_name] = ResidueType(
            name=res_name, res_id=rp.get_int("resID", 0),
            atom_names=atom_names, atom_types=atom_types, charges=charges,
            bonds=bonds, angles_h=angles_h, angles_cos=angles_cos,
            angles_reb=angles_reb, torsions=torsions, impropers=impropers,
            bpairs=bpairs, cons_groups=cons_groups, exclusions=exclusions)
    return out


def scan_residues(res_types: dict[str, ResidueType], species_names, gid):
    """Map particles to residue instances by gid-ordered species matching
    (<atomName>x<resName>, moleculeScanState analog,
    ddcMD src/molecule.c:117)."""
    order = np.argsort(np.asarray(gid), kind="stable")
    seq = [species_names[i] for i in order]
    # residue signature: list of species names in atom order
    sigs = {rn: (rt.species_sig or [f"{an}x{rn}" for an in rt.atom_names])
            for rn, rt in res_types.items()}
    instances = []  # (res_name, [state rows])
    i, n = 0, len(seq)
    while i < n:
        for rn, sig in sigs.items():
            m = len(sig)
            if i + m <= n and seq[i:i + m] == sig:
                instances.append((rn, [int(order[i + k]) for k in range(m)]))
                i += m
                break
        else:
            raise DeckError(f"particle {order[i]} ({seq[i]}) starts no known residue")
    return instances


def instantiate_bonded(res_types: dict[str, ResidueType], instances,
                       lj_cutoff: float) -> BondedTerms:
    """Expand per-type term templates over residue instances."""
    bonds, bparm = [], []
    angles, aparm, akind = [], [], []
    tors, tparm = [], []
    imps, iparm = [], []
    bprs, bpparm = [], []
    excl = []
    cons_atoms, cons_pairs, cons_dist = [], [], []

    for rn, rows in instances:
        rt = res_types[rn]
        rows = np.asarray(rows)
        for (i, j, kb, b0) in rt.bonds:
            bonds.append((rows[i], rows[j]))
            bparm.append((kb, b0))
            excl.append((rows[i], rows[j]))
        for kind, lst in ((0, rt.angles_h), (1, rt.angles_cos), (2, rt.angles_reb)):
            for (i, j, k, kt, t0) in lst:
                angles.append((rows[i], rows[j], rows[k]))
                aparm.append((kt, t0))
                akind.append(kind)
        for (i, j, k, l, kchi, n, delta) in rt.torsions:
            tors.append((rows[i], rows[j], rows[k], rows[l]))
            tparm.append((kchi, float(n), delta))
        for (i, j, k, l, kpsi, psi0) in rt.impropers:
            imps.append((rows[i], rows[j], rows[k], rows[l]))
            iparm.append((kpsi, psi0))
        for (i, j, sigma, eps) in rt.bpairs:
            sr6 = (sigma / lj_cutoff) ** 6
            shift = -4.0 * eps * (sr6 * sr6 - sr6)
            bprs.append((rows[i], rows[j]))
            bpparm.append((sigma, eps, shift))
        for (i, j) in rt.exclusions:
            excl.append((rows[i], rows[j]))
        for grp in rt.cons_groups:
            atoms = sorted({a for (i, j, _) in grp for a in (i, j)})
            amap = {a: s for s, a in enumerate(atoms)}
            cons_atoms.append([rows[a] for a in atoms])
            cons_pairs.append([(amap[i], amap[j]) for (i, j, _) in grp])
            cons_dist.append([r0 for (_, _, r0) in grp])
            for (i, j, _) in grp:
                excl.append((rows[i], rows[j]))

    def arr(x, dt=np.int32):
        return np.asarray(x, dtype=dt) if x else None

    # pad constraint groups
    CA = CP = CD = None
    n_cons = 0
    if cons_atoms:
        max_m = max(len(a) for a in cons_atoms)
        max_n = max(len(p) for p in cons_pairs)
        CA = np.full((len(cons_atoms), max_m), -1, dtype=np.int32)
        CP = np.zeros((len(cons_atoms), max_n, 2), dtype=np.int32)
        CD = np.zeros((len(cons_atoms), max_n), dtype=np.float64)
        for g, (a, p, d) in enumerate(zip(cons_atoms, cons_pairs, cons_dist)):
            CA[g, : len(a)] = a
            CP[g, : len(p)] = p
            CD[g, : len(d)] = d
            n_cons += len(p)

    # dedupe exclusions
    if excl:
        es = sorted({(min(i, j), max(i, j)) for (i, j) in excl})
        excl = np.asarray(es, dtype=np.int32)
    else:
        excl = None

    return BondedTerms(
        bonds=arr(bonds), bond_parms=arr(bparm, np.float64),
        angles=arr(angles), angle_parms=arr(aparm, np.float64),
        angle_kind=arr(akind),
        torsions=arr(tors), torsion_parms=arr(tparm, np.float64),
        impropers=arr(imps), improper_parms=arr(iparm, np.float64),
        bpairs=arr(bprs), bpair_parms=arr(bpparm, np.float64),
        exclusions=excl,
        cons_atoms=CA, cons_pairs=CP, cons_dist=CD, n_constraints=n_cons,
    )


def device_bonded_tables(bt: BondedTerms, dtype=torch.float32, device="cpu",
                         *, lj_sigma=None, lj_eps=None, lj_shift=None,
                         rcut=None, keR=None, charges=None,
                         species_lj_type=None, species_per_particle=None,
                         excl_mode="rf_add", krf=None, crf=None):
    """Move instantiated terms to the device; precompute exclusion pair
    data (counterpart of the JAX package's device_bonded_tables).  Only
    excl_mode "rf_add" exists here: the pair engine masks excluded pairs
    and the exclusion term adds back the kept RF polarization part.
    Scalars (cutoffs squared, krf, crf) are host floats rounded to
    `dtype`, as the pair engines round them."""
    if excl_mode != "rf_add":
        raise ValueError(
            f"excl_mode={excl_mode!r}: the port masks excluded pairs in the "
            "pair engine and only adds back their RF part (rf_add); it never "
            "computes and subtracts them")

    def ten(x, dt=None):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    def scalar(x):
        return float(torch.tensor(x, dtype=dtype))

    t = {}
    for key, parms in (("bonds", "bond_parms"), ("angles", "angle_parms"),
                       ("torsions", "torsion_parms"),
                       ("impropers", "improper_parms"),
                       ("bpairs", "bpair_parms")):
        if getattr(bt, key) is not None:
            t[key] = ten(getattr(bt, key), torch.int64)
            t[parms] = ten(getattr(bt, parms), dtype)
    if bt.angles is not None:
        t["angle_kind"] = ten(bt.angle_kind, torch.int64)
    if bt.bpairs is not None:
        t["bpair_rcut2"] = scalar(rcut ** 2)
    if bt.cmap_atoms is not None:
        from .charmm import _CMAP_AINV      # the bicubic-patch inverse

        t["cmap_atoms"] = ten(bt.cmap_atoms, torch.int64)
        t["cmap_type"] = ten(bt.cmap_type, torch.int64)
        for k in ("cmap_grid", "cmap_y1", "cmap_y2", "cmap_y12"):
            t[k] = ten(getattr(bt, k), dtype)
        t["cmap_ainv"] = ten(_CMAP_AINV, dtype)
    if bt.exclusions is not None and lj_sigma is not None:
        ex = bt.exclusions
        tmap = np.asarray(species_lj_type)
        sp = np.asarray(species_per_particle)
        T = lj_sigma.shape[0]
        ti = tmap[sp[ex[:, 0]]]
        tj = tmap[sp[ex[:, 1]]]
        t["exclusions"] = ten(ex, torch.int64)
        t["excl_tidx"] = ten(ti * T + tj, torch.int64)
        qv = np.asarray(charges)
        t["excl_qq"] = ten(keR * qv[ex[:, 0]] * qv[ex[:, 1]], dtype)
        t["sigma_flat"] = ten(np.asarray(lj_sigma).reshape(-1), dtype)
        t["eps_flat"] = ten(np.asarray(lj_eps).reshape(-1), dtype)
        t["shift_flat"] = ten(np.asarray(lj_shift).reshape(-1), dtype)
        t["rcut2"] = scalar(rcut ** 2)
        t["excl_mode"] = "rf_add"
        t["excl_krf"] = scalar(krf)
        t["excl_crf"] = scalar(crf)
    return t


# ---------------------------------------------------------------------------
# device evaluation: per-family term math on (..., 3) displacements (the
# generic evaluator's (T, 3), the batched evaluator's (M, T, 3)); `w`, when
# given, broadcasts against the per-term energies and gates each term
# ---------------------------------------------------------------------------

# the families of the term tables, in emission order, and their arity
FAMILIES = (("bonds", 2), ("angles", 3), ("torsions", 4), ("impropers", 4),
            ("cmap_atoms", 5), ("bpairs", 2), ("exclusions", 2))


def _gate(x, w):
    return x if w is None else x * w


def _norm(d):
    return torch.sqrt((d * d).sum(-1))


def outer_sum(f, d):
    """sum over terms of f (x) d: a family's virial part."""
    return torch.einsum("...a,...c->ac", f, d)


def bond_term(dr, parm, w=None):
    """(e, f_i) of harmonic bonds on dr = r_i - r_j; f_j = -f_i."""
    b = _norm(dr)
    kb, b0 = parm[..., 0], parm[..., 1]
    db = b - b0
    e = _gate(kb * db * db, w)                   # no 1/2 (CHARMM)
    fi = _gate(-2.0 * kb * db / b, w)[..., None] * dr
    return e, fi


def angle_term(rij, rkj, parm, kind, w=None):
    """(e, f_i, f_k) of the three angle kinds (0 harmonic in theta, 1 G96
    cosine, 2 REB) on rij = r_i - r_j, rkj = r_k - r_j; f_j = -(f_i + f_k)."""
    bij, bkj = _norm(rij), _norm(rkj)
    uij = rij / bij[..., None]
    ukj = rkj / bkj[..., None]
    cosA = torch.clamp((uij * ukj).sum(-1), -1.0 + 1e-7, 1.0 - 1e-7)
    kt, t0 = parm[..., 0], parm[..., 1]
    sin2 = 1.0 - cosA * cosA
    sinA = torch.sqrt(sin2)
    aD_h = torch.arccos(cosA) - t0
    aD_c = cosA - t0
    e_k = (kt * aD_h * aD_h, kt * aD_c * aD_c, kt * aD_c * aD_c / sin2)
    coef_k = (2.0 * kt * aD_h / sinA, -2.0 * kt * aD_c,
              -2.0 * kt * aD_c * (1.0 - cosA * t0) / (sin2 * sin2))
    e = coef = torch.zeros_like(cosA)
    for k in range(3):
        e = torch.where(kind == k, e_k[k], e)
        coef = torch.where(kind == k, coef_k[k], coef)
    e, coef = _gate(e, w), _gate(coef, w)
    fi = (coef / bij)[..., None] * (ukj - uij * cosA[..., None])
    fk = (coef / bkj)[..., None] * (uij - ukj * cosA[..., None])
    return e, fi, fk


def _dihedral(b1, b2, b3):
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    x = (n1 * n2).sum(-1)
    y = (torch.linalg.cross(n1, n2, dim=-1) * b2).sum(-1) / _norm(b2)
    return torch.atan2(y, x)


def _torsion_energy(d0, d2, d3, parm, harmonic):
    phi = _dihedral(-d0, d2, d3 - d2)
    if harmonic:
        kpsi, psi0 = parm[..., 0], parm[..., 1]
        dphi = phi - psi0
        dphi = dphi - 2.0 * torch.pi * torch.round(dphi / (2.0 * torch.pi))
        return kpsi * dphi * dphi
    kchi, nper, delta = parm[..., 0], parm[..., 1], parm[..., 2]
    return kchi * (1.0 + torch.cos(nper * phi - delta))


def autograd_term(energy, *d):
    """(per-term energies, [-dE/dd for each d]) of `energy(*d)`, the
    forces by reverse-mode autograd of the summed energy (the JAX
    package's jax.vjp), whatever the caller's grad mode."""
    with torch.enable_grad():
        dg = [x.detach().requires_grad_(True) for x in d]
        e = energy(*dg)
        g = torch.autograd.grad(e.sum(), dg)
    return e.detach(), [-x for x in g]


def torsion_term(d0, d2, d3, parm, harmonic, w=None):
    """(e, f_i, f_k, f_l) of dihedrals (harmonic: CHARMM impropers) on the
    displacements d0, d2, d3 of atoms i, k, l from atom j; f_j = -(f_i +
    f_k + f_l)."""
    e, (fi, fk, fl) = autograd_term(
        lambda a, b, c: _gate(_torsion_energy(a, b, c, parm, harmonic), w),
        d0, d2, d3)
    return e, fi, fk, fl


def bpair_term(dr, parm, rcut2, w=None):
    """(e, f_i) of bonded LJ pairs (the CHARMM 1-4s) within rcut2."""
    r2 = (dr * dr).sum(-1)
    ir2 = 1.0 / r2
    sg, ep, sh = parm[..., 0], parm[..., 1], parm[..., 2]
    s2 = sg * sg * ir2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    within = _gate((r2 < rcut2).to(dr.dtype), w)
    e = (4.0 * ep * (s12 - s6) + sh) * within
    dvdr = 24.0 * ep * (s6 - 2.0 * s12) * ir2 * within
    return e, -dvdr[..., None] * dr


def excl_rf_term(dr, qq, rcut2, krf, crf, w=None):
    """(e, f_i) of the rf_add exclusion term: the pair engine masked these
    pairs; add back only the RF polarization part (bioMartini.c:1124-1208)."""
    r2 = (dr * dr).sum(-1)
    within = _gate((r2 < rcut2).to(dr.dtype), w)
    e = qq * (krf * r2 - crf) * within
    dvdr = qq * (2.0 * krf) * within
    return e, -dvdr[..., None] * dr


def _cmap_energy(dP, dCA, dC, dN2, ctype, grid, y1, y2, y12, ainv):
    """Per-term CMAP energies (M,): grid coordinates u = 180 - deg(phi),
    v = 180 - deg(psi) (resCmap, bioCharmmCovalentEnergies.c:670-677);
    the cell indices come from detached angles (the JAX package's
    stop_gradient); ainv is the bicubic patch's inverse (16, 16)."""
    ng = grid.shape[-1]
    res = 360.0 / ng
    phi = _dihedral(-dP, dCA, dC - dCA)
    psi = _dihedral(dCA, dC - dCA, dN2 - dC)
    u = 180.0 - phi * (180.0 / torch.pi)
    v = 180.0 - psi * (180.0 / torch.pi)
    iu = torch.clamp(torch.floor(u.detach() / res), 0, ng - 1).long()
    iv = torch.clamp(torch.floor(v.detach() / res), 0, ng - 1).long()
    iup = (iu + 1) % ng
    ivp = (iv + 1) % ng

    # the value and the three derivative maps (in grid units) at the
    # cell's four corners, map-major: one gather
    tabs = torch.stack([grid, y1 * res, y2 * res, y12 * (res * res)], 1)
    cu = torch.stack([iu, iup, iu, iup])
    cv = torch.stack([iv, iv, ivp, ivp])
    maps = torch.arange(4, device=u.device)[:, None, None]
    x16 = tabs[ctype, maps, cu[None], cv[None]].reshape(16, -1)
    coef = ainv @ x16                                   # (16, M)
    c = coef.reshape(4, 4, -1).permute(1, 0, 2)         # c[i,j] = coef[j,i]
    t1 = (u - iu.to(u.dtype) * res) / res
    t2 = (v - iv.to(u.dtype) * res) / res
    p1 = torch.stack([torch.ones_like(t1), t1, t1 * t1, t1 ** 3])
    p2 = torch.stack([torch.ones_like(t2), t2, t2 * t2, t2 ** 3])
    return torch.einsum("ijm,im,jm->m", c, p1, p2)


def bonded_eval(r, box_geom, terms: dict, n_pad: int, dtype):
    """Evaluate every family of `terms` (device_bonded_tables, or the
    leftover dict of bonded_batch.build_batched_bonded) by per-term row
    gathers and index_add_ scatters; returns (f (n_pad, 3), e, virial
    (3, 3), pe (n_pad,)) with e == sum(pe).  box_geom: (3,) lengths or a
    triclinic (3, 3) h.

    Optional per-family weights terms["<family>_w"] (T,) gate single
    terms (0 = off); an off term is evaluated on a fixed non-degenerate
    geometry, so its arbitrary (possibly coincident) rows stay finite."""
    geom = box_geom.to(dtype)
    dev = r.device
    f = torch.zeros((n_pad, 3), dtype=dtype, device=dev)
    pe = torch.zeros((n_pad,), dtype=dtype, device=dev)
    e = torch.zeros((), dtype=dtype, device=dev)
    virial = torch.zeros((3, 3), dtype=dtype, device=dev)

    def disp(key, idx, a, b, unit):
        """min-image r[a] - r[b] of each term; off terms get `unit`."""
        d = nearest_image(r[idx[:, a]] - r[idx[:, b]], geom)
        w = terms.get(key + "_w")
        if w is None:
            return d
        return torch.where((w > 0)[:, None], d,
                           torch.tensor(unit, dtype=dtype, device=dev))

    for key, R in FAMILIES:
        if key not in terms:
            continue
        idx = terms[key]
        w = terms.get(key + "_w")
        if key == "bonds":
            dr = disp(key, idx, 0, 1, (1.0, 0.0, 0.0))
            et, fi = bond_term(dr, terms["bond_parms"], w)
            fs, pes = [fi, -fi], [0.5 * et, 0.5 * et]
            virial = virial + outer_sum(fi, dr)
        elif key == "angles":
            rij = disp(key, idx, 0, 1, (1.0, 0.0, 0.0))
            rkj = disp(key, idx, 2, 1, (0.0, 1.0, 0.0))
            et, fi, fk = angle_term(rij, rkj, terms["angle_parms"],
                                    terms["angle_kind"], w)
            z = torch.zeros_like(et)
            fs, pes = [fi, -(fi + fk), fk], [z, et, z]
            virial = virial + outer_sum(fi, rij) + outer_sum(fk, rkj)
        elif key in ("torsions", "impropers"):
            # corners as min-image displacements about atom j
            d0 = disp(key, idx, 0, 1, (1.0, 0.0, 0.0))
            d2 = disp(key, idx, 2, 1, (0.0, 1.0, 0.0))
            d3 = disp(key, idx, 3, 1, (0.0, 1.0, 1.0))
            parm = terms["torsion_parms" if key == "torsions"
                         else "improper_parms"]
            et, fi, fk, fl = torsion_term(d0, d2, d3, parm,
                                          key == "impropers", w)
            z = torch.zeros_like(et)
            fs, pes = [fi, -(fi + fk + fl), fk, fl], [z, et, z, z]
            virial = virial + outer_sum(fi, d0) + outer_sum(fk, d2) \
                + outer_sum(fl, d3)
        elif key == "cmap_atoms":
            # [-C, N, CA, C, +N], anchored at N
            ds = [disp(key, idx, a, 1, u) for a, u in (
                (0, (-1.0, 0.0, 0.0)), (2, (0.0, 1.0, 0.0)),
                (3, (0.0, 1.0, 1.0)), (4, (1.0, 1.0, 1.0)))]
            tabs = [terms[k] for k in ("cmap_type", "cmap_grid", "cmap_y1",
                                       "cmap_y2", "cmap_y12", "cmap_ainv")]
            et, fc = autograd_term(
                lambda *d: _gate(_cmap_energy(*d, *tabs), w), *ds)
            fP, fCA, fC, fN2 = fc
            z = torch.zeros_like(et)
            fs = [fP, -(fP + fCA + fC + fN2), fCA, fC, fN2]
            pes = [z, et, z, z, z]
            virial = virial + sum(outer_sum(fx, dx) for fx, dx in zip(fc, ds))
        elif key == "bpairs":
            dr = disp(key, idx, 0, 1, (1.0, 0.0, 0.0))
            et, fi = bpair_term(dr, terms["bpair_parms"],
                                terms["bpair_rcut2"], w)
            fs, pes = [fi, -fi], [0.5 * et, 0.5 * et]
            virial = virial + outer_sum(fi, dr)
        else:
            dr = disp(key, idx, 0, 1, (1.0, 0.0, 0.0))
            et, fi = excl_rf_term(dr, terms["excl_qq"], terms["rcut2"],
                                  terms["excl_krf"], terms["excl_crf"], w)
            fs, pes = [fi, -fi], [0.5 * et, 0.5 * et]
            virial = virial + outer_sum(fi, dr)
        for rr in range(R):
            f.index_add_(0, idx[:, rr], fs[rr])
            pe.index_add_(0, idx[:, rr], pes[rr])
        e = e + et.sum()
    return f, e, virial, pe
