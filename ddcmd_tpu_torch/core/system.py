"""SYSTEM assembly: deck + collection -> runnable simulation pieces.

Counterpart of ddcmd_tpu/core/system.py (system_init, ddcMD
src/system.c; simulate_init, src/simulate.c:104-297), cut to the decks
the port runs: MARTINI and CHARMM potentials, with the covalent
topology of the residues (bonds, angles, torsions, impropers, bonded LJ
pairs, exclusions, constraints; CHARMM's chain links and CMAP)
instantiated over the collection, PAIR Lennard-Jones, EAM metals of
ATOM species (analytic or tabulated), RESTRAINT springs, REFLECT walls and NONE / ZEROPOTENTIAL
terms (no force), in an orthorhombic or a triclinic box, static or
prescribed in time (box(t): boxPrescriptiveTime.c).
Anything else raises NotImplementedError naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import os
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..io.collection import CollectionData, read_collection
from ..nbr.celllist import CellGrid
from ..objects import DeckError, ObjectDB
from ..objects import units as U
from .box import Box
from .groups import Group, GroupTable, group_from_deck
from .species import Species, species_from_deck
from .state import State


@dataclass
class SimulateConfig:
    dt: float                  # internal ps
    maxloop: int
    loop: int
    time: float                # internal ps
    printrate: int
    deltaloop: int | None
    integrator_name: str
    system_name: str
    printinfo_name: str | None
    ddc_update_rate: int
    checkpointrate: int = 0
    snapshotrate: int = 0
    nLoopDigits: int = 6
    gidFormat: str = "dec"
    nfiles: int = 1            # checkpoint shard count (Pio_setNumWriteFiles)
    # FULL = f8 velocities; BRIEF = f4 velocities in binary checkpoints
    checkpointprecision: str = "FULL"


@dataclass
class SystemDef:
    """Host-side assembled system (everything needed to build device fns)."""

    db: ObjectDB
    cfg: SimulateConfig
    species: list[Species]
    groups: list[Group]
    group_table: GroupTable
    potentials: list               # list of (type, name, parms)
    box: Box
    state: State
    collection: CollectionData
    neighbor_deltaR: float         # skin, internal
    rcut_max: float                # max potential cutoff, internal
    integrator_type: str
    integrator_parms: dict
    n_constraints: int = 0
    random_seed: int = 0
    bonded: object | None = None   # potentials.bonded.BondedTerms
    residue_instances: list | None = None  # (res_name, state rows) pairs
    box_time: dict | None = None   # prescribed box(t) (boxPrescriptiveTime.c)


def _find_simulate(db: ObjectDB) -> SimulateConfig:
    sims = db.by_class("SIMULATE")
    if not sims:
        raise DeckError("no SIMULATE object in deck")
    sim = sims[0]
    return SimulateConfig(
        dt=sim.get_with_units("dt", "1.0", "t"),
        maxloop=sim.get_int("maxloop", 0),
        loop=sim.get_int("loop", 0),
        time=U.parse_with_units(" ".join(sim.raw("time", "0.0")), "t"),
        printrate=sim.get_int("printrate", 1),
        deltaloop=sim.get_int("deltaloop", 0) or None,
        integrator_name=sim.get_str("integrator", "nglf"),
        system_name=sim.get_str("system", "system"),
        printinfo_name=sim.get_str("printinfo", "") or None,
        ddc_update_rate=_ddc_update_rate(db, sim),
        checkpointrate=sim.get_int("checkpointrate", 0),
        snapshotrate=sim.get_int("snapshotrate", 0),
        nLoopDigits=sim.get_int("nLoopDigits", 6),
        gidFormat=sim.get_str("gidFormat", "dec"),
        nfiles=max(1, sim.get_int("nfiles", 1)),
        checkpointprecision=sim.get_str("checkpointprecision",
                                        "FULL").upper(),
    )


def _ddc_update_rate(db: ObjectDB, sim) -> int:
    name = sim.get_str("ddc", "")
    if name:
        ddc = db.find(name, "DDC")
        if ddc is not None:
            return ddc.get_int("updateRate", 20)
    return 20


def _parse_box_time(boxobj) -> dict | None:
    """Prescribed time-dependent box (boxPrescriptiveTimeParse, ddcMD
    src/boxPrescriptiveTime.c:10-95; system.py:102-151 of the JAX
    package).

    Modes: STRAIN (full 3x3 of dudt eq targets; h_ij *= exp(int u_ij dt)
    elementwise, boxPrescriptiveTime.c:102-117 -- 1/2/3 elements fill
    the diagonal, 9 the full matrix), VOLUME_FUNCTION_OF_TIME (Veq =
    per-atom volume eq target), DEFORMATION_RATE (full h <- h expm(D dt)),
    ROTATION (constant h = R h0, applied at build -- the reference never
    integrates it in time).  Off-diagonal terms run on the triclinic
    cell-block engine.
    """
    from ..objects.eq import eq_parse

    if boxobj.has("dudt"):
        u = boxobj.get_strv("dudt")
        n = len(u)
        zero = "0.0"
        if n == 0:
            grid9 = [zero] * 9
        elif n == 1:
            grid9 = [u[0], zero, zero, zero, u[0], zero, zero, zero, u[0]]
        elif n == 2:
            grid9 = [u[0], zero, zero, zero, u[1], zero, zero, zero, u[1]]
        elif n == 3:
            grid9 = [u[0], zero, zero, zero, u[1], zero, zero, zero, u[2]]
        elif n == 9:
            grid9 = list(u)
        else:
            raise DeckError(f"dudt expects 1/2/3/9 elements, got {n}")
        eqs = tuple(tuple(eq_parse(grid9[3 * i + j], "1/t", "t")
                          for j in range(3)) for i in range(3))
        return dict(mode="strain", eqs=eqs)
    veq = boxobj.get_literal("Veq", "")
    if veq.strip():
        return dict(mode="volume",
                    eq=eq_parse(veq.replace(" ", ""), "l^3", "t"))
    if boxobj.has("deformationRate"):
        d = boxobj.get_with_unitsv("deformationRate", "0 0 0 0 0 0 0 0 0",
                                   "1/t")
        if any(abs(x) > 0 for x in d):
            return dict(mode="deformation",
                        D=np.asarray(d, dtype=np.float64).reshape(3, 3))
    if boxobj.has("rotationMatrix"):
        R = np.asarray(boxobj.get_floatv("rotationMatrix"),
                       dtype=np.float64).reshape(3, 3)
        if not np.allclose(R, 0.0):
            return dict(mode="rotation", R=R)
    return None


def _box_time_tilts(bt: dict) -> bool:
    """True when a prescribed box(t) can grow off-diagonal h terms.
    STRAIN is elementwise-multiplicative (h_ij *= exp(..)): zero entries
    stay zero, so it never tilts a diagonal box; only an off-diagonal
    DEFORMATION_RATE (h <- h expm(D dt)) does."""
    if bt["mode"] == "deformation":
        D = bt["D"]
        return bool(np.any(D != np.diag(np.diagonal(D))))
    return False


def build_system(db: ObjectDB, base_dir: str = ".", *, dtype=torch.float32,
                 device="cpu", pad_multiple: int = 128) -> SystemDef:
    cfg = _find_simulate(db)
    sysobj = db.get(cfg.system_name, "SYSTEM")

    # --- box (h possibly merged in from restart) ---------------------------
    boxobj = db.get(sysobj.get_str("box", "box"), "BOX")
    pbc = boxobj.get_int("pbc", 7)
    hvals = boxobj.get_with_unitsv("h", "", "l") if boxobj.has("h") else None

    # --- collection ----------------------------------------------------------
    colname = sysobj.get_str("collection", "collection")
    colobj = db.find(colname, "COLLECTION")
    if colobj is None or not colobj.has("files"):
        raise DeckError("COLLECTION with files= required (restart must be compiled in)")
    col = read_collection(colobj.get_str("files"), base_dir,
                          header_length=colobj.get_int("headerLength", 0))
    if hvals is None:
        hvals = [v * U.ANG_TO_LENGTH for v in col.header.get_floatv("h")]
    h0 = np.asarray(hvals, dtype=np.float64).reshape(3, 3)
    box_time = _parse_box_time(boxobj)
    if box_time is not None and box_time["mode"] == "rotation":
        # constant h = R h0 (boxPrescriptiveTime.c:141-143 never
        # integrates ROTATION in time): fold into the static box
        h0 = box_time["R"] @ h0
        box_time = None
    box = Box.from_h(h0, pbc=pbc, dtype=dtype, device=device)
    if box_time is not None and _box_time_tilts(box_time):
        # an off-diagonal deformation tilts the box mid-run: the
        # triclinic paths from step one
        box = dataclasses.replace(box, ortho=False)

    # --- species -------------------------------------------------------------
    sp_names_decl = sysobj.get_strv("species")
    if not sp_names_decl:
        sp_names_decl = list(dict.fromkeys(col.species_names))
    species = []
    for i, name in enumerate(sp_names_decl):
        if db.find(name, "SPECIES") is not None:
            species.extend(species_from_deck(db, [name]))
            species[-1].index = i
        else:
            species.append(Species(name=name, index=i, type="ATOM",
                                   charge=0.0, mass=1.0))
    sp_index = {s.name: s.index for s in species}

    # --- groups ----------------------------------------------------------------
    grp_names = sysobj.get_strv("groups")
    if not grp_names:
        grp_names = sorted(set(col.group_names))
    groups = [group_from_deck(db, n, i) for i, n in enumerate(grp_names)]
    grp_index = {g.name: g.index for g in groups}
    group_table = GroupTable.build(groups)

    # --- per-particle arrays ------------------------------------------------------
    try:
        sidx = np.array([sp_index[s] for s in col.species_names], dtype=np.int64)
    except KeyError as e:
        raise DeckError(f"collection references unknown species {e}") from None
    try:
        gidx = np.array([grp_index[g] for g in col.group_names], dtype=np.int64)
    except KeyError as e:
        raise DeckError(f"collection references unknown group {e}") from None

    # --- potentials ------------------------------------------------------------
    potentials = []
    rcut_max = 0.0
    for pname in sysobj.get_strv("potential"):
        ptype = db.get(pname, "POTENTIAL").get_str("type").upper()
        if ptype == "MARTINI":
            from ..potentials.martini import compile_martini

            parms = compile_martini(db, pname)
        elif ptype == "EAM":
            from ..potentials.eam import compile_eam

            # the EAM type index is the species index
            parms = compile_eam(db, pname, species, base_dir)
        elif ptype == "PAIR":
            from ..potentials.pair import compile_pair

            parms = compile_pair(db, pname, species, base_dir)
        elif ptype == "RESTRAINT":
            from ..potentials.restraint import compile_restraint

            parms = compile_restraint(db, pname)
            if parms is not None:
                potentials.append((ptype, pname, parms))
            continue
        elif ptype == "REFLECT":
            # a post-drift hook of the step (potentials/reflect.py)
            potentials.append((ptype, pname, None))
            continue
        elif ptype in ("NONE", "ZEROPOTENTIAL"):
            # no force, no cutoff (system.py:308-309 of the JAX package)
            potentials.append(("NONE", pname, None))
            continue
        elif ptype == "ORDERSH":
            # the Steinhardt order bias; its cutoff is r2o
            from ..potentials.ordersh import compile_ordersh

            parms = compile_ordersh(db, pname)
            rcut_max = max(rcut_max, parms.r2o)
            potentials.append((ptype, pname, parms))
            continue
        elif ptype == "PAIRENERGY":
            from ..potentials.pairenergy import compile_pairenergy

            parms = compile_pairenergy(db, pname, species)
        elif ptype == "CHARMM":
            from ..potentials.charmm import compile_charmm

            parms, res_types = compile_charmm(db, pname, base_dir)
            parms.charmm_res_types = res_types
            # species the deck does not declare take mass and charge
            # from the RTF
            for s in species:
                if s.name in parms.species_mass:
                    s.mass = parms.species_mass[s.name]
                    s.charge = parms.species_charge[s.name]
            # the same nonbond engines as MARTINI
            rcut_max = max(rcut_max, parms.rcut)
            potentials.append(("MARTINI", pname, parms))
            continue
        else:
            raise DeckError(f"POTENTIAL type {ptype} not implemented yet")
        rcut_max = max(rcut_max, parms.rcut)
        potentials.append((ptype, pname, parms))

    mass = np.array([species[i].mass for i in sidx])
    charge = np.array([species[i].charge for i in sidx])
    state = State.create(col.r, col.v, charge, mass, sidx, gidx, col.gid,
                         dtype=dtype, device=device, pad_multiple=pad_multiple)

    # Martini species need their LJ type index instead of species index for
    # the nonbond table lookup
    for ptype, pname, parms in potentials:
        if ptype != "MARTINI":
            continue
        tmap = np.zeros(len(species), dtype=np.int64)
        for s in species:
            if s.name not in parms.species_to_type:
                raise DeckError(f"species {s.name} has no MMFF atom type")
            tmap[s.index] = parms.species_to_type[s.name]
        parms.species_lj_type = tmap  # attached for force-builder use
    bonded, residue_instances, n_constraints = build_topology(
        db, sysobj, potentials, col.species_names, col.gid)

    # --- neighbor config ----------------------------------------------------------
    nbrobj = db.find(sysobj.get_str("neighbor", "nbr"), "NEIGHBOR")
    deltaR = nbrobj.get_with_units("deltaR", "4.0", "l") if nbrobj else 0.4

    # --- integrator ------------------------------------------------------------------
    itype, iparms = integrator_parms_from_deck(db, cfg.integrator_name)

    # --- random seed ---------------------------------------------------------------
    seed = 0
    rname = sysobj.get_str("random", "")
    if rname:
        robj = db.find(rname, "RANDOM")
        if robj is not None:
            seed = robj.get_int("seed", 0)
            if robj.get_int("randomizeSeed", 0):
                seed = int.from_bytes(os.urandom(4), "little")

    return SystemDef(
        db=db, cfg=cfg, species=species, groups=groups, group_table=group_table,
        potentials=potentials, box=box, state=state, collection=col,
        neighbor_deltaR=deltaR, rcut_max=rcut_max,
        integrator_type=itype, integrator_parms=iparms,
        n_constraints=n_constraints, random_seed=seed, bonded=bonded,
        residue_instances=residue_instances, box_time=box_time,
    )


def build_topology(db: ObjectDB, sysobj, potentials, species_names, gid):
    """The covalent topology of the deck's MARTINI (or CHARMM) term over a
    collection: its residue templates instantiated over the particles
    (genMartiniConn analog, bioMartini.c:567-830), CHARMM's +X/-X chain
    links and CMAP terms, and the constraint count (the SYSTEM's
    nConstraints unless the topology has constraints; countConstraints
    analog).  Returns (bonded, residue_instances, n_constraints), bonded
    and residue_instances None without such a term.  Run by build_system
    and again by Simulation.apply_transform on a changed collection."""
    bonded = residue_instances = None
    for ptype, pname, parms in potentials:
        if ptype != "MARTINI":
            continue
        from ..potentials.bonded import (compile_residue_types,
                                         instantiate_bonded, scan_residues)

        charmm = getattr(parms, "charmm_res_types", None)
        res_types = charmm or compile_residue_types(db, pname, parms.rcut)
        residue_instances = scan_residues(res_types, species_names, gid)
        bonded = instantiate_bonded(res_types, residue_instances, parms.rcut)
        if charmm is not None:
            from ..potentials.charmm import add_chain_links

            add_chain_links(bonded, parms, residue_instances, gid,
                            parms.rcut)
    n_constraints = sysobj.get_int("nConstraints", 0)
    if bonded is not None and bonded.n_constraints > 0:
        n_constraints = bonded.n_constraints
    return bonded, residue_instances, n_constraints


def integrator_parms_from_deck(db: ObjectDB, name: str):
    """(type, parms) for an INTEGRATOR deck object: the thermostat target,
    the Berendsen barostat parameters of NGLFCONSTRAINT
    (nglfconstraint.c:64-85), NPTGLF's and NGLFNK's."""
    iobj = db.get(name, "INTEGRATOR")
    itype = iobj.get_str("type").upper()
    iparms = dict(
        T=iobj.get_with_units("T", "310", "T"),
        P0=iobj.get_with_units("P0", "0.0", "pressure"),
        beta=iobj.get_with_units("beta", "0.0", "1/pressure"),
        tauBarostat=iobj.get_with_units("tauBarostat", "0.0", "t"),
        isotropic=bool(iobj.get_int("isotropic", 0)),
        # NPTGLF (nptglf_parms, ddcMD src/nptglf.c:24-31)
        Gamma=iobj.get_with_units("Gamma", "1.0", "m/l^4"),
        zeta=iobj.get_with_units("zeta", "1.0", "pressure*t"),
        pressure=iobj.get_with_units("pressure", "1.0", "pressure"),
        # NGLFNK Langevin-piston NPT (nglfNK_parms, src/nglfNK.c:28-37)
        P=iobj.get_with_units("P", "0.0", "pressure"),
        W=iobj.get_with_unitsv("W", "1.0 1.0 1.0", "m"),
        tau=iobj.get_with_units("tau", "1.0", "t"),
    )
    return itype, iparms


def plan_grid(sysdef: SystemDef, density_safety: float = 2.0,
              plan_margin: float = 1.0, box=None) -> CellGrid:
    """The (N,K)-list engine's plan at `box` (the system's box by
    default).  A triclinic box plans its cell counts from the
    perpendicular plane spacings, so a one-shell stencil still covers
    rlist (the lengths overestimate the width of tilted cells)."""
    box = sysdef.box if box is None else box
    L = (box.lengths if box.ortho else box.perp_spans).cpu().numpy()
    return CellGrid.plan(L.astype(np.float64), sysdef.rcut_max,
                         sysdef.neighbor_deltaR, sysdef.state.n_local,
                         sysdef.state.n_pad, density_safety=density_safety,
                         plan_margin=plan_margin)
