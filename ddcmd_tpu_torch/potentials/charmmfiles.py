"""CHARMM topology (RTF) and parameter (PAR) file readers.

Counterpart of ddcmd_tpu/potentials/charmmfiles.py, a copy (jax-free
host code).  The reference (ddcMD src/bioCharmmTop.c, bioCharmmPar.c)
reads the standard public CHARMM force-field file formats; this is a
clean-room reader of those formats:

RTF:  MASS <id> <type> <mass> [elem]
      RESI <name> <charge> / PRES ...
      GROUP / ATOM <name> <type> <charge> / BOND|DOUBLE <a b>... /
      IMPR <i j k l>... / CMAP ... / DONOR/ACCEPTOR/IC/DELETE (ignored)
PAR:  sections BONDS, ANGLES (optional Urey-Bradley tail), DIHEDRALS
      (X wildcards, multiple multiplicities), IMPROPER, CMAP (grids),
      NONBONDED (type ignored eps -Rmin/2 [ignored eps14 -Rmin14/2]),
      NBFIX (pair overrides), HBOND (ignored).

Units in files: kcal/mol, Angstrom, degrees -- converted to internal
units here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..objects import units as U

KCAL = U.unit_scale("kcal/mol")
ANG = U.unit_scale("Angstrom")
DEG = math.pi / 180.0


@dataclass
class RtfResidue:
    name: str
    charge: float
    atoms: list[tuple]          # (name, type, charge)
    bonds: list[tuple]          # (nameI, nameJ); +X/-X = next/prev residue
    imprs: list[tuple]          # (n1, n2, n3, n4); may contain +X/-X
    cmaps: list[tuple] = field(default_factory=list)  # 8 names per entry
    groups: list[list[int]] = field(default_factory=list)  # atom idx per GROUP
    deletes: list[str] = field(default_factory=list)       # DELETE ATOM names
    is_patch: bool = False


@dataclass
class CharmmTop:
    masses: dict[str, float] = field(default_factory=dict)    # type -> amu
    residues: dict[str, RtfResidue] = field(default_factory=dict)


@dataclass
class CharmmPar:
    bonds: dict[tuple, tuple] = field(default_factory=dict)    # (t1,t2)->(kb,b0)
    cmaps: dict[tuple, object] = field(default_factory=dict)   # 8types->(N,N) grid
    angles: dict[tuple, tuple] = field(default_factory=dict)   # (t1,t2,t3)->(kt,t0,kub,s0)
    dihedrals: dict[tuple, list] = field(default_factory=dict)  # -> [(k,n,delta)...]
    impropers: dict[tuple, tuple] = field(default_factory=dict)  # -> (kpsi, psi0)
    lj: dict[str, tuple] = field(default_factory=dict)          # type->(eps, rmin_half)
    lj14: dict[str, tuple] = field(default_factory=dict)
    nbfix: dict[tuple, tuple] = field(default_factory=dict)     # (t1,t2)->(eps, rmin)


def _clean_lines(path):
    """Strip comments (!), join continuations (trailing -), skip blanks."""
    out = []
    cont = ""
    with open(path) as f:
        for raw in f:
            line = raw.split("!")[0].rstrip()
            if not line.strip():
                continue
            if line.rstrip().endswith("-"):
                cont += line.rstrip()[:-1] + " "
                continue
            line = cont + line
            cont = ""
            out.append(line.strip())
    return out


def read_rtf(path) -> CharmmTop:
    top = CharmmTop()
    resi: RtfResidue | None = None
    for line in _clean_lines(path):
        toks = line.split()
        kw = toks[0].upper()
        if kw.startswith("MASS") and len(toks) >= 4:
            top.masses[toks[2]] = float(toks[3])
        elif kw.startswith("RESI") or kw.startswith("PRES"):
            resi = RtfResidue(name=toks[1], charge=float(toks[2]) if len(toks) > 2 else 0.0,
                              atoms=[], bonds=[], imprs=[],
                              is_patch=kw.startswith("PRES"))
            top.residues[resi.name] = resi
        elif resi is None:
            continue
        elif kw == "GROUP":
            resi.groups.append([])
        elif kw == "ATOM" and len(toks) >= 4:
            if not resi.groups:
                resi.groups.append([])
            resi.groups[-1].append(len(resi.atoms))
            resi.atoms.append((toks[1], toks[2], float(toks[3])))
        elif kw in ("DELETE", "DELE") and len(toks) >= 3 \
                and toks[1].upper().startswith("ATOM"):
            resi.deletes.extend(toks[2:])
        elif kw in ("BOND", "DOUB", "DOUBLE", "TRIPLE"):
            pairs = toks[1:]
            for i in range(0, len(pairs) - 1, 2):
                resi.bonds.append((pairs[i], pairs[i + 1]))
        elif kw in ("IMPR", "IMPROPER", "IMPH"):
            quad = toks[1:]
            for i in range(0, len(quad) - 3, 4):
                resi.imprs.append(tuple(quad[i:i + 4]))
        elif kw == "CMAP":
            names = toks[1:]
            for i in range(0, len(names) - 7, 8):
                resi.cmaps.append(tuple(names[i:i + 8]))
        # GROUP/DONOR/ACCEPTOR/IC/DELETE/ANGLE/DIHE lines ignored
        # (angles/dihedrals are autogenerated from bonds, as CHARMM does)
    return top


_SECTIONS = ("BONDS", "ANGLES", "THETAS", "DIHEDRALS", "PHI", "IMPROPER",
             "IMPHI", "NONBONDED", "NBFIX", "CMAP", "HBOND", "END")


def read_par(path) -> CharmmPar:
    import numpy as np

    par = CharmmPar()
    section = None
    cmap_key = None
    cmap_n = 0
    cmap_vals: list[float] = []

    def flush_cmap():
        nonlocal cmap_key, cmap_vals
        if cmap_key is not None and len(cmap_vals) == cmap_n * cmap_n:
            par.cmaps[cmap_key] = (np.asarray(cmap_vals)
                                   .reshape(cmap_n, cmap_n) * KCAL)
        cmap_key = None
        cmap_vals = []

    for line in _clean_lines(path):
        toks = line.split()
        kw = toks[0].upper()
        matched = None
        for s in _SECTIONS:
            if kw.startswith(s[:4]):
                matched = s
                break
        if matched:
            if section == "CMAP" and matched != "CMAP":
                flush_cmap()
            section = matched
            continue
        if section == "CMAP":
            # header: 8 atom types + grid size; then rows of grid values
            # (kcal/mol, phi-major from -180 in 360/N steps)
            try:
                vals = [float(x) for x in toks]
            except ValueError:
                flush_cmap()
                cmap_key = tuple(toks[:8])
                cmap_n = int(float(toks[8])) if len(toks) > 8 else 24
                continue
            if cmap_key is not None:
                cmap_vals.extend(vals)
                if len(cmap_vals) >= cmap_n * cmap_n:
                    flush_cmap()
            continue
        if section in ("BONDS",):
            if len(toks) >= 4:
                t = tuple(sorted(toks[:2]))
                par.bonds[t] = (float(toks[2]) * KCAL / ANG ** 2,
                                float(toks[3]) * ANG)
        elif section in ("ANGLES", "THETAS"):
            if len(toks) >= 5:
                t1, t2, t3 = toks[:3]
                key = (t1, t2, t3) if t1 <= t3 else (t3, t2, t1)
                kub = s0 = 0.0
                if len(toks) >= 7:
                    try:
                        kub = float(toks[5]) * KCAL / ANG ** 2
                        s0 = float(toks[6]) * ANG
                    except ValueError:
                        pass
                par.angles[key] = (float(toks[3]) * KCAL,
                                   float(toks[4]) * DEG, kub, s0)
        elif section in ("DIHEDRALS", "PHI"):
            if len(toks) >= 7:
                key = tuple(toks[:4])
                if key[::-1] < key:
                    key = key[::-1]
                par.dihedrals.setdefault(key, []).append(
                    (float(toks[4]) * KCAL, int(float(toks[5])),
                     float(toks[6]) * DEG))
        elif section in ("IMPROPER", "IMPHI"):
            if len(toks) >= 7:
                key = tuple(toks[:4])
                if key[::-1] < key:
                    key = key[::-1]
                par.impropers[key] = (float(toks[4]) * KCAL,
                                      float(toks[6]) * DEG)
        elif section == "NONBONDED":
            if len(toks) >= 4:
                try:
                    eps = float(toks[2])
                    rmin_half = float(toks[3])
                except ValueError:
                    continue  # section modifier line (cutnb etc)
                par.lj[toks[0]] = (abs(eps) * KCAL, rmin_half * ANG)
                if len(toks) >= 7:
                    try:
                        par.lj14[toks[0]] = (abs(float(toks[5])) * KCAL,
                                             float(toks[6]) * ANG)
                    except ValueError:
                        pass
        elif section == "NBFIX":
            if len(toks) >= 4:
                t = tuple(sorted(toks[:2]))
                par.nbfix[t] = (abs(float(toks[2])) * KCAL,
                                float(toks[3]) * ANG)
    flush_cmap()
    return par


def lookup_bond(par: CharmmPar, t1, t2):
    return par.bonds.get(tuple(sorted((t1, t2))))


def lookup_angle(par: CharmmPar, t1, t2, t3):
    key = (t1, t2, t3) if t1 <= t3 else (t3, t2, t1)
    return par.angles.get(key)


def lookup_dihedral(par: CharmmPar, t1, t2, t3, t4):
    """Specific match first, then X wildcards (CHARMM rule)."""
    for key in ((t1, t2, t3, t4), (t4, t3, t2, t1),
                ("X", t2, t3, "X"), ("X", t3, t2, "X")):
        hit = par.dihedrals.get(key) or par.dihedrals.get(key[::-1])
        if hit:
            return hit
    return None


def lookup_improper(par: CharmmPar, t1, t2, t3, t4):
    cands = ((t1, t2, t3, t4), (t4, t3, t2, t1),
             (t1, "X", "X", t4), (t4, "X", "X", t1))
    for key in cands:
        hit = par.impropers.get(key) or par.impropers.get(key[::-1])
        if hit:
            return hit
    return None
