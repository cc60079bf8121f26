"""CHARMM all-atom force field: RTF/PAR -> nonbond tables + covalent terms.

Counterpart of ddcmd_tpu/potentials/charmm.py, whose host code this is a
copy of: the RTF/PAR compiler, the terminal patches, the chain links and
the CMAP spline.  The terms it compiles are evaluated by
potentials/bonded_batch.py (per residue type) and potentials/bonded.py
(bonded_eval: the terms that cross residue instances and CMAP).

Reference pipeline: charmm_parms (ddcMD src/bioCharmm.c:237-340)
reads topfile/parfile, builds per-residue connection lists
(bioCharmmParms.c), evaluates with the shared CHARMM/Martini engines.
Functional forms (verified against bioCharmm.c:105-129 and the covalent
engines):

  LJ:    eps [ (Rmin/r)^12 - 2 (Rmin/r)^6 ] + shift(rc)
         == 4 eps [ (s/r)^12 - (s/r)^6 ] + shift with s = Rmin 2^(-1/6)
         Rmin_ij = Rmin_i/2 + Rmin_j/2, eps_ij = sqrt(eps_i eps_j)
  elec:  reaction-field Coulomb exactly as Martini (shared CHARMMPOT
         krf/crf machinery)
  bond:  kb (b-b0)^2 ;  Urey-Bradley: kub (S-S0)^2 (extra 1-3 "bond")
  angle: ktheta (theta-theta0)^2  (radians)
  dihedral: kchi (1 + cos(n chi - delta)), multiple multiplicities
  improper: kpsi (psi - psi0)^2
  1-4:   excluded from nonbond; re-added as a pair term with the LJ14
         parameters (bpair machinery; the RF polarization part of the
         electrostatics stays via the exclusion correction, matching the
         reference's intra-molecule reaction-field treatment).

Angles/dihedrals are autogenerated from the RTF bond graph (CHARMM
AUTO ANGLES DIHE).  Inter-residue +X/-X bonds link consecutive residues
of the same molecule (molecule = gid>>32, the reference bio gid layout,
bioCharmmCovalentEnergies.c:560-566); cross-junction angles/dihedrals/
impropers/1-4s are autogenerated over the combined two-residue bond
graph, and CMAP phi/psi corrections are instantiated per residue triple
(resCmap, bioCharmmCovalentEnergies.c:536-760).  NOTE: the public
reference stubs its CMAP spline precompute (bioCharmmParms.c:1385-1386
assert(0)); the natural-cubic-spline derivative maps implemented here
are the intended behavior per computeCMAPDerivatives
(bioCharmmParms.c:1388-1448).
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from ..objects import DeckError, ObjectDB
from .bonded import ResidueType
from .charmmfiles import (lookup_angle, lookup_bond, lookup_dihedral,
                          lookup_improper, read_par, read_rtf)
from .martini import MartiniParms

_SIGMA_FROM_RMIN = 2.0 ** (-1.0 / 6.0)


def _autogen(bonds_idx: list[tuple], n_atoms: int):
    """Angles (i-j-k) and dihedrals (i-j-k-l) from the bond graph."""
    adj = [[] for _ in range(n_atoms)]
    for i, j in bonds_idx:
        adj[i].append(j)
        adj[j].append(i)
    angles = []
    for j in range(n_atoms):
        for i, k in itertools.combinations(sorted(adj[j]), 2):
            angles.append((i, j, k))
    dihedrals = []
    for j, k in bonds_idx:
        for i in adj[j]:
            if i == k:
                continue
            for l in adj[k]:
                if l == j or l == i:
                    continue
                dihedrals.append((i, j, k, l))
    # dedupe reversed duplicates
    seen = set()
    uniq = []
    for d in dihedrals:
        key = d if d <= d[::-1] else d[::-1]
        if key not in seen:
            seen.add(key)
            uniq.append(d)
    return angles, uniq


def _apply_patch(resi, patch, where, *, skip_impr_n=False):
    """Apply a PRES terminal patch: replace the first (NTER) or last
    (CTER) GROUP with the patch's group, drop deleted atoms' bonds and
    impropers, append the patch's own (charmmConvertResType NTER/CTER
    paths, ddcMD src/bioCharmmParms.c:446-720)."""
    from .charmmfiles import RtfResidue

    ggroups = [[resi.atoms[i] for i in g] for g in (resi.groups or
                                                    [list(range(len(resi.atoms)))])]
    pgroup = [patch.atoms[i] for i in (patch.groups[0] if patch.groups
                                       else range(len(patch.atoms)))]
    if where == "first":
        ggroups = [pgroup] + ggroups[1:]
    else:
        ggroups = ggroups[:-1] + [pgroup]
    atoms = [a for g in ggroups for a in g]
    have = {a[0] for a in atoms}
    dele = set(patch.deletes)

    def keep_tok(t):
        return t[0] in "+-" or (t in have and t not in dele)

    bonds = [(a, b) for (a, b) in resi.bonds
             if a not in dele and b not in dele and keep_tok(a) and keep_tok(b)]
    bonds += list(patch.bonds)
    imprs = [q for q in resi.imprs
             if not any(t in dele or (t[0] not in "+-" and t not in have)
                        for t in q)
             and not (skip_impr_n and q[0] == "N")]
    imprs += list(patch.imprs)
    out = RtfResidue(name=resi.name, charge=resi.charge, atoms=atoms,
                     bonds=bonds, imprs=imprs, cmaps=list(resi.cmaps),
                     deletes=[], is_patch=False)
    n = 0
    for g in ggroups:
        out.groups.append(list(range(n, n + len(g))))
        n += len(g)
    return out


def _terminal_variants(top):
    """{res_type key: (RtfResidue, base resname, species delimiter)} for
    every residue plus NTER/CTER variants of amino acids (GLYP/PROP
    specials, bioCharmmParms.c:446-460)."""
    out = {}
    nter = top.residues.get("NTER")
    cter = top.residues.get("CTER")
    for rname, resi in top.residues.items():
        if resi.is_patch or not resi.atoms:
            continue
        out[rname] = (resi, rname, "x")
        names = {a[0] for a in resi.atoms}
        is_aa = any(b in ("+N",) or a in ("+N",) for a, b in resi.bonds) \
            and {"N", "CA", "C"} <= names
        if not is_aa:
            continue
        np_ = top.residues.get("GLYP") if rname == "GLY" else \
            (top.residues.get("PROP") if rname == "PRO" else nter)
        if np_ is not None:
            var = _apply_patch(resi, np_, "first",
                               skip_impr_n=(rname == "PRO"))
            # N-terminal residue keeps its C +N link; register under the
            # variant key so chain linking finds it
            out[rname + "__nter"] = (var, rname, "n")
            var.name = rname + "__nter"
        if cter is not None:
            var = _apply_patch(resi, cter, "last")
            out[rname + "__cter"] = (var, rname, "c")
            var.name = rname + "__cter"
    return out


def compile_charmm(db: ObjectDB, potential_name: str, base_dir: str = "."):
    """Returns (MartiniParms-compatible nonbond tables, residue types dict,
    masses by species name)."""
    import os

    pot = db.get(potential_name, "POTENTIAL")
    topfile = pot.get_str("topfile", "top_all22_prot.inp")
    parfile = pot.get_str("parfile", "par_all22_prot.inp")
    top = read_rtf(os.path.join(base_dir, topfile))
    par = read_par(os.path.join(base_dir, parfile))

    cutoff = pot.get_with_units("cutoff", "12.0", "Angstrom")
    rcoulomb = pot.get_with_units("rcoulomb", "12.0", "Angstrom")
    epsilon_r = pot.get_float("epsilon_r", 1.0)
    epsilon_rf = pot.get_float("epsilon_rf", -1.0)
    irc = 1.0 / rcoulomb
    irc3 = irc ** 3
    if epsilon_rf != -1.0:
        krf = (epsilon_rf - epsilon_r) / (2 * epsilon_rf + epsilon_r) * irc3
        crf = 3 * epsilon_rf / (2 * epsilon_rf + epsilon_r) * irc
    else:
        krf = 0.5 * irc3
        crf = 1.5 * irc

    # atom types actually used (patches introduce terminal types: NH3...)
    used_types = sorted({t for r in top.residues.values()
                         for (_, t, _) in r.atoms})
    tindex = {t: i for i, t in enumerate(used_types)}
    T = len(used_types)
    sigma = np.zeros((T, T))
    eps = np.zeros((T, T))
    for a in used_types:
        for b in used_types:
            ea, ra = par.lj.get(a, (0.0, 0.0))
            eb, rb = par.lj.get(b, (0.0, 0.0))
            key = tuple(sorted((a, b)))
            if key in par.nbfix:
                e_ab, rmin_ab = par.nbfix[key]
            else:
                e_ab = math.sqrt(ea * eb)
                rmin_ab = ra + rb
            sigma[tindex[a], tindex[b]] = rmin_ab * _SIGMA_FROM_RMIN
            eps[tindex[a], tindex[b]] = e_ab
    sr = np.divide(sigma, cutoff, out=np.zeros_like(sigma), where=sigma > 0)
    s6 = sr ** 6
    shift = -4.0 * eps * (s6 * s6 - s6)

    def build_template(key, resi, rname):
        names = [a[0] for a in resi.atoms]
        types = [a[1] for a in resi.atoms]
        charges = [a[2] for a in resi.atoms]
        idx = {n: i for i, n in enumerate(names)}
        bonds_idx = []
        for a, b in resi.bonds:
            if a in idx and b in idx:  # +X/-X cross links handled per chain
                bonds_idx.append((idx[a], idx[b]))
        angles_idx, dihedrals_idx = _autogen(bonds_idx, len(names))

        bonds, angles_h, torsions, impropers, bpairs, exclusions = [], [], [], [], [], []
        for i, j in bonds_idx:
            bp = lookup_bond(par, types[i], types[j])
            if bp is None:
                raise DeckError(f"{rname}: no BOND parms {types[i]}-{types[j]}")
            bonds.append((i, j, bp[0], bp[1]))
        for i, j, k in angles_idx:
            ap = lookup_angle(par, types[i], types[j], types[k])
            if ap is None:
                raise DeckError(f"{rname}: no ANGLE parms {types[i]}-{types[j]}-{types[k]}")
            kt, t0, kub, s0 = ap
            angles_h.append((i, j, k, kt, t0))
            if kub > 0:
                bonds.append((i, k, kub, s0))  # Urey-Bradley 1-3 spring
            exclusions.append((i, k))
        onefour = set()
        for i, j, k, l in dihedrals_idx:
            terms = lookup_dihedral(par, types[i], types[j], types[k], types[l])
            if terms is None:
                continue  # CHARMM skips unparametrized autogen dihedrals
            for (kchi, n, delta) in terms:
                torsions.append((i, j, k, l, kchi, n, delta))
            pair = (min(i, l), max(i, l))
            onefour.add(pair)
        for i, j, k, l in resi.imprs:
            if not all(x in idx for x in (i, j, k, l)):
                continue
            ii, jj, kk, ll = idx[i], idx[j], idx[k], idx[l]
            ip = lookup_improper(par, types[ii], types[jj], types[kk], types[ll])
            if ip is None:
                continue
            impropers.append((ii, jj, kk, ll, ip[0], ip[1]))
        # 1-4 pairs: exclude + re-add with LJ14 parameters
        excl_set = {(min(i, j), max(i, j)) for (i, j, *_rest) in bonds} | set(exclusions)
        for (i, l) in sorted(onefour):
            if (i, l) in excl_set:
                continue  # 1-4 that is also 1-2/1-3 in rings
            ei, ri = par.lj14.get(types[i], par.lj.get(types[i], (0.0, 0.0)))
            el, rl = par.lj14.get(types[l], par.lj.get(types[l], (0.0, 0.0)))
            e14 = math.sqrt(ei * el)
            s14 = (ri + rl) * _SIGMA_FROM_RMIN
            # bpair stores (i, j, sigma, eps) in the 4*eps LJ form; our
            # bonded compiler computes the shift
            bpairs.append((i, l, s14, e14))
            exclusions.append((i, l))

        return ResidueType(
            name=key, res_id=0, atom_names=names,
            atom_types=[tindex[t] for t in types], charges=charges,
            bonds=bonds, angles_h=angles_h, angles_cos=[], angles_reb=[],
            torsions=torsions, impropers=impropers, bpairs=bpairs,
            cons_groups=[], exclusions=exclusions)

    # residue types -> bonded term templates (plus NTER/CTER-patched
    # variants for amino-acid residues; variant selection by the species
    # delimiter x/n/c as in the reference bio decks, resCmap
    # bioCharmmCovalentEnergies.c:585-610)
    res_types: dict[str, ResidueType] = {}
    species_to_type: dict[str, int] = {}
    species_mass: dict[str, float] = {}
    species_charge: dict[str, float] = {}
    variants = _terminal_variants(top)
    for key, (resi, rname, delim) in variants.items():
        if not resi.atoms:
            continue
        res_types[key] = build_template(key, resi, rname)
        res_types[key].species_sig = [f"{a[0]}{delim}{rname}"
                                      for a in resi.atoms]
        if key not in top.residues:
            top.residues[key] = resi   # chain linker resolves by key
        for n, t, q in resi.atoms:
            sp = f"{n}{delim}{rname}"
            species_to_type[sp] = tindex[t]
            species_mass[sp] = top.masses.get(t, 1.0)
            species_charge[sp] = q

    parms = MartiniParms(
        n_types=T, sigma=sigma, eps=eps, shift=shift,
        rcut=cutoff, rcoulomb=rcoulomb, epsilon_r=epsilon_r,
        epsilon_rf=epsilon_rf, krf=krf, crf=crf,
        type_names=used_types, species_to_type=species_to_type)
    parms.species_mass = species_mass
    parms.species_charge = species_charge
    parms._charmm_chain = dict(top=top, par=par)
    return parms, res_types


# ---------------------------------------------------------------------------
# inter-residue chain links + CMAP

_CMAP_AINV = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [-3, 3, 0, 0, -2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [2, -2, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, -3, 3, 0, 0, -2, -1, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, -2, 0, 0, 1, 1, 0, 0],
    [-3, 0, 3, 0, 0, 0, 0, 0, -2, 0, -1, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, -3, 0, 3, 0, 0, 0, 0, 0, -2, 0, -1, 0],
    [9, -9, -9, 9, 6, 3, -6, -3, 6, -6, 3, -3, 4, 2, 2, 1],
    [-6, 6, 6, -6, -3, -3, 3, 3, -4, 4, -2, 2, -2, -2, -1, -1],
    [2, 0, -2, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 2, 0, -2, 0, 0, 0, 0, 0, 1, 0, 1, 0],
    [-6, 6, 6, -6, -4, -2, 4, 2, -3, 3, -3, 3, -2, -1, -2, -1],
    [4, -4, -4, 4, 2, 2, -2, -2, 2, -2, 2, -2, 1, 1, 1, 1],
], dtype=np.float64)  # bicubic-patch inverse (determineCMAPCoef,
#                       bioCharmmCovalentEnergies.c:356-390)


def _spline_y2(y, dx):
    """Natural cubic spline second derivatives (uniform grid)."""
    n = len(y)
    u = np.zeros(n)
    y2 = np.zeros(n)
    for i in range(1, n - 1):
        sig = 0.5
        pp = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / pp
        u[i] = (y[i + 1] - 2.0 * y[i] + y[i - 1]) / dx
        u[i] = (6.0 * u[i] / (2.0 * dx) - sig * u[i - 1]) / pp
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def _spline_eval(xmin, dx, ya, y2a, x):
    """Cubic-spline value and first derivative at x."""
    klo = int(min(max((x - xmin) / dx, 0), len(ya) - 2))
    khi = klo + 1
    xlo = xmin + klo * dx
    a = (xlo + dx - x) / dx
    b = (x - xlo) / dx
    y = (a * ya[klo] + b * ya[khi]
         + ((a ** 3 - a) * y2a[klo] + (b ** 3 - b) * y2a[khi]) * dx * dx / 6.0)
    y1 = ((ya[khi] - ya[klo]) / dx
          + (-(3 * a * a - 1) * y2a[klo] + (3 * b * b - 1) * y2a[khi]) * dx / 6.0)
    return y, y1


def cmap_derivative_maps(grid):
    """map_y1 (d/dphi), map_y2 (d/dpsi), map_y12 per grid node via natural
    cubic splines on the wrap-extended 48x48 map (computeCMAPDerivatives,
    bioCharmmParms.c:1388-1448)."""
    nvals = grid.shape[0]
    stride = nvals // 2
    size = 2 * nvals
    dx = 360.0 / nvals
    deg_off = 180.0
    min_deg = -360.0
    tmp = np.empty((size, size))
    for i in range(size):
        ii = (i + nvals - stride) % nvals
        for j in range(size):
            jj = (j + nvals - stride) % nvals
            tmp[i, j] = grid[ii, jj]
    t = np.stack([_spline_y2(tmp[i], dx) for i in range(size)])
    y1m = np.zeros((nvals, nvals))
    y2m = np.zeros((nvals, nvals))
    y12m = np.zeros((nvals, nvals))
    for i in range(stride, nvals + stride):
        phi = (i - stride) * dx - deg_off
        for j in range(stride, nvals + stride):
            psi = (j - stride) * dx - deg_off
            ytemp = np.empty(size)
            y1temp = np.empty(size)
            for k in range(size):
                ytemp[k], y1temp[k] = _spline_eval(min_deg, dx, tmp[k],
                                                   t[k], psi)
            u2 = _spline_y2(ytemp, dx)
            _, v1 = _spline_eval(min_deg, dx, ytemp, u2, phi)
            u2 = _spline_y2(y1temp, dx)
            v2, v12 = _spline_eval(min_deg, dx, y1temp, u2, phi)
            y1m[i - stride, j - stride] = v1
            y2m[i - stride, j - stride] = v2
            y12m[i - stride, j - stride] = v12
    return y1m, y2m, y12m


def _junction_template(top, par, tindex, name_a, name_b, lj_cutoff):
    """Cross-junction covalent terms for linked residues A->B; atom slots
    are combined local indices (A atoms, then B atoms offset by nA).
    Returns None when the pair has no +X/-X bonds."""
    ra, rb = top.residues[name_a], top.residues[name_b]
    names_a = [x[0] for x in ra.atoms]
    names_b = [x[0] for x in rb.atoms]
    types = [x[1] for x in ra.atoms] + [x[1] for x in rb.atoms]
    na = len(names_a)
    ia = {n: i for i, n in enumerate(names_a)}
    ib = {n: na + i for i, n in enumerate(names_b)}

    def resolve(tok, side):
        """side 0 = token belongs to A's lists, 1 = B's."""
        if tok.startswith("+"):
            return ib.get(tok[1:]) if side == 0 else None
        if tok.startswith("-"):
            return ia.get(tok[1:]) if side == 1 else None
        return ia.get(tok) if side == 0 else ib.get(tok)

    cross_bonds = set()
    for side, resi in ((0, ra), (1, rb)):
        for a, b in resi.bonds:
            if not (a[0] in "+-" or b[0] in "+-"):
                continue
            i, j = resolve(a, side), resolve(b, side)
            if i is None or j is None:
                continue
            if (i < na) != (j < na):
                cross_bonds.add((min(i, j), max(i, j)))
    if not cross_bonds:
        return None

    bonds_idx = [(ia[a], ia[b]) for a, b in ra.bonds
                 if a in ia and b in ia] \
        + [(ib[a], ib[b]) for a, b in rb.bonds if a in ib and b in ib] \
        + sorted(cross_bonds)
    angles_idx, dihedrals_idx = _autogen(bonds_idx, na + len(names_b))

    def crosses(t):
        return any(x < na for x in t) and any(x >= na for x in t)

    bonds, angles, torsions, impropers, bpairs, excl = [], [], [], [], [], []
    for i, j in sorted(cross_bonds):
        bp = lookup_bond(par, types[i], types[j])
        if bp is None:
            raise DeckError(f"{name_a}-{name_b} link: no BOND parms "
                            f"{types[i]}-{types[j]}")
        bonds.append((i, j, bp[0], bp[1]))
    for i, j, k in angles_idx:
        if not crosses((i, j, k)):
            continue
        ap = lookup_angle(par, types[i], types[j], types[k])
        if ap is None:
            raise DeckError(f"{name_a}-{name_b} link: no ANGLE parms")
        kt, t0, kub, s0 = ap
        angles.append((i, j, k, kt, t0))
        if kub > 0:
            bonds.append((i, k, kub, s0))
        excl.append((i, k))
    onefour = set()
    for i, j, k, l in dihedrals_idx:
        if not crosses((i, j, k, l)):
            continue
        terms = lookup_dihedral(par, types[i], types[j], types[k], types[l])
        if terms is None:
            continue
        for (kchi, n, delta) in terms:
            torsions.append((i, j, k, l, kchi, n, delta))
        onefour.add((min(i, l), max(i, l)))
    for side, resi in ((0, ra), (1, rb)):
        for quad in resi.imprs:
            if not any(t[0] in "+-" for t in quad):
                continue
            rq = [resolve(t, side) for t in quad]
            if any(x is None for x in rq):
                continue
            ip = lookup_improper(par, *(types[x] for x in rq))
            if ip is None:
                continue
            impropers.append((*rq, ip[0], ip[1]))
    excl_set = {(min(i, j), max(i, j)) for (i, j, *_r) in bonds} \
        | {(min(i, k), max(i, k)) for (i, _j, k, *_r) in angles}
    for (i, l) in sorted(onefour):
        if (i, l) in excl_set:
            continue
        ei, ri = par.lj14.get(types[i], par.lj.get(types[i], (0.0, 0.0)))
        el, rl = par.lj14.get(types[l], par.lj.get(types[l], (0.0, 0.0)))
        s14 = (ri + rl) * _SIGMA_FROM_RMIN
        bpairs.append((i, l, s14, math.sqrt(ei * el)))
        excl.append((i, l))
    excl += [(i, j) for (i, j, *_r) in bonds]
    return dict(bonds=bonds, angles=angles, torsions=torsions,
                impropers=impropers, bpairs=bpairs, exclusions=excl)


def add_chain_links(bt, parms, instances, gid, lj_cutoff):
    """Instantiate inter-residue terms + CMAP over chains.

    Consecutive residue instances belong to the same chain when their
    molecule IDs (gid>>32, the reference's molMask layout) match.  Updates
    the BondedTerms arrays in place and attaches the CMAP term/grid data.
    """
    import warnings

    top = parms._charmm_chain["top"]
    par = parms._charmm_chain["par"]
    gid = np.asarray(gid, dtype=np.uint64)

    def mol_of(rows):
        return int(gid[rows[0]] >> np.uint64(32))

    linked = []   # i such that instance i links to i+1
    templates = {}
    new_bonds, new_bparm = [], []
    new_angles, new_aparm = [], []
    new_tors, new_tparm = [], []
    new_imps, new_iparm = [], []
    new_bprs, new_bpparm = [], []
    new_excl = []
    for i in range(len(instances) - 1):
        (na_, rows_a), (nb_, rows_b) = instances[i], instances[i + 1]
        if mol_of(rows_a) != mol_of(rows_b):
            continue
        key = (na_, nb_)
        if key not in templates:
            templates[key] = _junction_template(top, par, None, na_, nb_,
                                                lj_cutoff)
        tpl = templates[key]
        if tpl is None:
            continue
        linked.append(i)
        rows = np.concatenate([rows_a, rows_b])
        for (ii, jj, kb, b0) in tpl["bonds"]:
            new_bonds.append((rows[ii], rows[jj]))
            new_bparm.append((kb, b0))
        for (ii, jj, kk, kt, t0) in tpl["angles"]:
            new_angles.append((rows[ii], rows[jj], rows[kk]))
            new_aparm.append((kt, t0))
        for (ii, jj, kk, ll, kchi, n, delta) in tpl["torsions"]:
            new_tors.append((rows[ii], rows[jj], rows[kk], rows[ll]))
            new_tparm.append((kchi, float(n), delta))
        for (ii, jj, kk, ll, kpsi, psi0) in tpl["impropers"]:
            new_imps.append((rows[ii], rows[jj], rows[kk], rows[ll]))
            new_iparm.append((kpsi, psi0))
        for (ii, jj, sg, ep) in tpl["bpairs"]:
            sr6 = (sg / lj_cutoff) ** 6
            new_bprs.append((rows[ii], rows[jj]))
            new_bpparm.append((sg, ep, -4.0 * ep * (sr6 ** 2 - sr6)))
        for (ii, jj) in tpl["exclusions"]:
            new_excl.append((rows[ii], rows[jj]))

    # CMAP terms: center residue with both neighbors linked
    linked_set = set(linked)
    cmap_atoms, cmap_types = [], []
    grids = {}
    for i in range(1, len(instances) - 1):
        if (i - 1) not in linked_set or i not in linked_set:
            continue
        name_c, rows_c = instances[i]
        resi = top.residues[name_c]
        if not resi.cmaps:
            continue
        name_p, rows_p = instances[i - 1]
        name_n, rows_n = instances[i + 1]
        maps = {0: (name_p, rows_p), 1: (name_c, rows_c),
                2: (name_n, rows_n)}

        def atom_of(tok):
            side = 1
            nm = tok
            if tok.startswith("-"):
                side, nm = 0, tok[1:]
            elif tok.startswith("+"):
                side, nm = 2, tok[1:]
            rnm, rrows = maps[side]
            resd = top.residues[rnm]
            for k, (an, at, _q) in enumerate(resd.atoms):
                if an == nm:
                    return rrows[k], at
            return None, None

        for entry in resi.cmaps:
            pairs = [atom_of(t) for t in entry]
            if any(p[0] is None for p in pairs):
                continue
            typekey = tuple(p[1] for p in pairs)
            if typekey not in par.cmaps:
                warnings.warn(f"CMAP table {typekey} not in PAR; skipped")
                continue
            if typekey not in grids:
                grids[typekey] = len(grids)
            # 5 unique atoms: (-C, N, CA, C, +N) = rows of entry[0..3], [7]
            rowsq = [p[0] for p in pairs]
            cmap_atoms.append((rowsq[0], rowsq[1], rowsq[2], rowsq[3],
                               rowsq[7]))
            cmap_types.append(grids[typekey])

    def cat(cur, new, dt):
        if not new:
            return cur
        arr = np.asarray(new, dtype=dt)
        return arr if cur is None else np.concatenate([cur, arr])

    bt.bonds = cat(bt.bonds, new_bonds, np.int32)
    bt.bond_parms = cat(bt.bond_parms, new_bparm, np.float64)
    bt.angles = cat(bt.angles, new_angles, np.int32)
    bt.angle_parms = cat(bt.angle_parms, new_aparm, np.float64)
    if new_angles:
        bt.angle_kind = cat(bt.angle_kind, [0] * len(new_angles), np.int32)
    bt.torsions = cat(bt.torsions, new_tors, np.int32)
    bt.torsion_parms = cat(bt.torsion_parms, new_tparm, np.float64)
    bt.impropers = cat(bt.impropers, new_imps, np.int32)
    bt.improper_parms = cat(bt.improper_parms, new_iparm, np.float64)
    bt.bpairs = cat(bt.bpairs, new_bprs, np.int32)
    bt.bpair_parms = cat(bt.bpair_parms, new_bpparm, np.float64)
    if new_excl:
        cur = [] if bt.exclusions is None else [tuple(x) for x in bt.exclusions]
        allx = sorted({(min(i, j), max(i, j))
                       for (i, j) in cur + new_excl})
        bt.exclusions = np.asarray(allx, dtype=np.int32)
    if cmap_atoms:
        bt.cmap_atoms = np.asarray(cmap_atoms, dtype=np.int32)
        bt.cmap_type = np.asarray(cmap_types, dtype=np.int32)
        keys = sorted(grids, key=grids.get)
        gstack = np.stack([par.cmaps[k] for k in keys])
        y1s, y2s, y12s = [], [], []
        for g in gstack:
            a, b, c = cmap_derivative_maps(g)
            y1s.append(a)
            y2s.append(b)
            y12s.append(c)
        bt.cmap_grid = gstack
        bt.cmap_y1 = np.stack(y1s)
        bt.cmap_y2 = np.stack(y2s)
        bt.cmap_y12 = np.stack(y12s)
    # chain record for domain decomposition: instance i links to i+1.
    # Migration coherence must be per CHAIN, not per residue -- the
    # junction terms above cross residue instances, and a chain split
    # across devices loses the ghost-side bonded forces (ddcRuleMolecule
    # keeps whole molecules on one rank, ddcRuleMolecule.c:43).
    bt.chain_links = np.asarray(sorted(linked_set), dtype=np.int64)
    return bt
