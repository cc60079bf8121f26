"""Bonded (covalent) topology and the device tables of the batched terms.

Counterpart of ddcmd_tpu/potentials/bonded.py, host part: residue
templates compiled from the MMFF RESIPARMS trees (`compile_residue_types`),
particles matched to residue instances (`scan_residues`), the templates
expanded over the instances (`instantiate_bonded`), and the term tables
moved to the device (`device_bonded_tables`).  These are copies of the
JAX package's host code.

Forms (ddcMD src/bioCharmmCovalentEnergiesSorted.c):

  bond (func 1):      e = kb (b - b0)^2              (CHARMM convention, no 1/2)
  angle (func 1):     e = ktheta (theta - theta0)^2, theta0 raw radians
  angle cos (func 2): e = ktheta (cosA - theta0)^2, theta0 raw cosine
  angle REB (func 10):e = ktheta (cosA - theta0)^2 / sin^2 A
  exclusion:          excluded (bonded) pairs are masked in the pair
                      kernel; the reaction-field polarization part the
                      reference keeps for them (martiniIntraMoleReaction,
                      bioMartini.c:1124-1208) is added back here:
                      e = keR qi qj (krf r^2 - crf) within the cutoff.

The port never computes excluded pairs and subtracts them afterwards
(the JAX package's "subtract" mode): the f32 residual of a ~1e9 LJ wall
on a deeply compressed bond is an energy-injecting catapult.  Torsions,
impropers, bonded LJ pairs and CMAP compile here but have no evaluator
in the port yet (ROADMAP queue 1, item 12); `core/system.py` refuses
decks that carry them.  The evaluation of bonds, angles and exclusions
runs in potentials/bonded_batch.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
    excl_mode "rf_add" exists here: the pair kernel masks excluded pairs
    and the exclusion term adds back the kept RF polarization part."""
    if excl_mode != "rf_add":
        raise ValueError(
            f"excl_mode={excl_mode!r}: the port masks excluded pairs in the "
            "pair kernel and only adds back their RF part (rf_add); it never "
            "computes and subtracts them")

    def ten(x, dt=None):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    t = {}
    if bt.bonds is not None:
        t["bonds"] = ten(bt.bonds, torch.int64)
        t["bond_parms"] = ten(bt.bond_parms, dtype)
    if bt.angles is not None:
        t["angles"] = ten(bt.angles, torch.int64)
        t["angle_parms"] = ten(bt.angle_parms, dtype)
        t["angle_kind"] = ten(bt.angle_kind, torch.int64)
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
        # host scalars, rounded as the pair engine rounds them
        t["rcut2"] = float(torch.tensor(rcut ** 2, dtype=dtype))
        t["excl_mode"] = "rf_add"
        t["excl_krf"] = float(torch.tensor(krf, dtype=dtype))
        t["excl_crf"] = float(torch.tensor(crf, dtype=dtype))
    return t
