"""simulateMaster: the MD run loop, fixed-cadence shape.

Counterpart of ddcmd_tpu/run/simulate.py (reference ddcMD
src/masters.c:369-559), reduced to the main paths: NGLF / NGLFCONSTRAINT
with the Berendsen barostat and RATTLE constraints, the NVEGLF variants
(plain leapfrog kicks), NPTGLF and NGLFNK (integrators/nptglf.py,
nglfnk.py), every GROUP type with Teq_dynamics=GLOBAL_ENERGY, a
prescribed box(t) (STRAIN, VOLUME, DEFORMATION_RATE; ROTATION is folded
into the box at build), MARTINI nonbond and
PAIR Lennard-Jones through the cell-pair kernels plus the batched bonded
terms, EAM through the two-pass EAM kernels, RESTRAINT springs, REFLECT
walls and NONE terms, and on the (N,K)-list engine also PAIRENERGY, the
ORDERSH bias and the PAIR TableFunction.

The engine is the JAX package's choice (simulate.py:50-118, choose_engine)
with "pallas" read as "kernel": the kernels for f32, orthorhombic, fully
periodic decks whose EAM term (if any) the EAM kernels take; the plain
cell-block engines ("cellblock", ops/cellpair.cellpair_eval_half and
ops/cellpair_eam.eam_cellblock_eval_half, no kernel) for decks with
non-periodic axes, triclinic boxes, f64, TABULAR EAM without
tabularFit=rational or EAM of more than 4 species; the (N,K)-list engine
("nlist", nbr/celllist.py and the list terms of run/forces.py, plain
PyTorch, no kernel) for decks with PAIRENERGY or ORDERSH and decks
whose exclusion graph has a component wider than the cell engines'
12-member encoding.  Where the JAX choice gives a wrong result the port
raises instead: a TableFunction PAIR deck (zero pair force on the JAX
cell engines) asks for engine="nlist".  Where a JAX engine is wrong on
non-periodic axes the port masks them: the cell-block EAM engine drops
the stencil blocks that cross a wall (the JAX one takes images through
it), and the list keeps the full stencil on a non-periodic axis of
fewer than 3 cells and takes the minimum image on the periodic axes
only.  The cell-block plan is
CellBlockGrid.plan's and an overflow grows its cap by 1.5; the list's is
core/system.plan_grid's and an overflow grows its cell capacity and K
by 1.5.

One dispatch runs k steps as n_rebuilds blocks of `updateRate` steps:
each block rebuilds the cell slots or the list (the cell engines wrap
positions there; the list engine wraps after every drift, as the JAX
step does), then runs its steps on that handle.  Nothing in a dispatch
reads the device; the per-step scalars (with the hottest particle's
|v| and row), the overflow flag and the worst displacement are reduced
on the device and copied to the host once at the end of the dispatch
(the JAX package's superchunk_fixed, simulate.py:489-537).  The host
then checks them:

  * overflow (a rebuild dropped particles or pairs, or a shrinking box
    took a cell edge below rlist -- `cell_edge_bad`): the dispatch is
    discarded and the grid replanned at the live box; if that changes
    nothing, the kernels' density safety grows by 1.3 first (the cell
    engines' and the list's room by 1.5).  Dynamic-box decks that keep
    overflowing halve the dispatch so the host replans along the
    compression;
  * non-finite energy: the dispatch is rolled back (the pre-dispatch
    state is intact) and retried with fresh thermostat noise (attempts
    1-3 of kick_noise), with a warning naming the step, the dispatch,
    the last good row and the hottest particle's history; a fourth
    failure writes the pre-dispatch state as a checkpoint without
    moving the `restart` link and raises the kill switch
    (saveState/restoreState, masters.c:461-475; the JAX package's
    simulate.py:1012-1077);
  * verlet-skin staleness (2 (max|dr| + 2 max|dh|) >= deltaR on a step
    that reused a list, dh the box motion since the rebuild): the
    dispatch is discarded and redone from the intact pre-dispatch state
    at halved rebuild cadence.  The thermostat noise is keyed by global
    step and attempt, so the redo replays the same noise.  Eight clean
    dispatches in a row double the cadence (and the dispatch) back; a
    stale redo restarts that count.

After an accepted dispatch the host writes the printinfo rows, the
`graphs` line (PRINTINFO printGraphs=1) and, with more than one group,
each group's `group_<name>.data` row at printrate; evaluates, then
writes, each SIMULATE analysis= object (and printStress's STRESSWRITE)
whose eval_rate, then outputrate, divides the loop (analysis/registry.py);
applies each SIMULATE transform= object whose rate divides the loop
(apply_transform: the registry's host surgery, then a re-upload or, when
the particle count or the species changed, a rebuild of the state, the
engine, the plan and the step), so an analysis at a transform's loop
sees the state before it; then checkpoints and snapshots at their rates,
and reads `ddcMD_CMDS` in the run directory (checkpoint, exit, kill,
stop, profile, analysis, hpm, and object text that is compiled and
rescanned; readCmds.c:20-97; a rescan that fails is undone with a
warning and a profile that fails prints "profile: FAILED").  Dispatches
end on the checkpoint, snapshot, transform and analysis rates.  Host
spans are timed into utils/profile.PROFILE ("loop", "printinfo",
"analysis", md_steps), and
`profile_phases` times the rebuild, the force, the group kick and the
fused step as calls of their own.  The NEXTFILE integrator replays
snapshot files and NGLFTEST / NGLFERROR measures the integrator's
position error (run_nextfile, run_nglftest).

Dynamic boxes (a barostat's beta > 0, NPTGLF, NGLFNK, a box(t); the
JAX package's dyn_box) plan the grid with a 1.08 margin on rlist, so
compression does not trip the cell-edge guard right away, and count
their box motion in the staleness test.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time as _time
import warnings

import numpy as np
import torch

from ..core.energy import EnergyInfo
from ..core.groups import kick_noise, union_callsite, velocity_update
from ..core.molecule import build_molecule_class, make_molecular_virial_fn
from ..core.system import build_system, plan_grid
from ..integrators.nglf import StepState, first_energy_call, make_nglf_step
from ..integrators.nglfnk import make_nglfnk_step
from ..integrators.nptglf import make_nptglf_step
from ..io.collection import read_collection
from ..nbr.celllist import build_neighbor_list
from ..objects import ObjectDB
from ..objects import units as U
from ..ops.cellpair import CellBlockGrid, build_cell_slots
from ..ops.cellpair_half import plan_lanes
from ..ops.eam_half import eam_half_supported
from ..potentials.pair import TABLE_ENGINE
from ..utils.profile import PROFILE
from .forces import build_force_fn, wide_exclusion_component
from .printinfo import PrintInfo

# integrator types with the Berendsen barostat (when beta > 0)
_BAROSTAT_TYPES = ("NGLFCONSTRAINT", "NGLFCONSTRAINTGPU",
                   "NGLFCONSTRAINTGPULANGEVIN", "NGLFGPU", "NGLFGPULANGEVIN",
                   "NGLFNEW")
# NVE variants: the NGLF step on plain leapfrog coefficients (nveglf.c)
_NVE_TYPES = ("NVEGLF", "NVEGLF_SIMPLE")
# integrators with a step of their own (integrators/nptglf.py, nglfnk.py)
_NPT_TYPES = ("NPTGLF", "NGLFNK")
# integrator types whose run is a master of its own (Simulation.run_nextfile,
# run_nglftest); every other type runs the NGLF step, as in the JAX
# package (simulate.py:264-355)
_MASTER_TYPES = ("NEXTFILE", "NGLFTEST", "NGLFERROR")
_NOISE_CALLSITE_NGLF = 0
# columns of the per-step row a dispatch returns: the hottest particle's
# |v|^2 and its row trace a blowup back (the JAX package's columns 11-12)
_ROW = ("eion", "rk", "tr_virial", "tr_tion", "volume", "Lx", "Ly", "Lz",
        "vmax2", "vrow")
# NaN rollback: retries of one dispatch before the kill switch
_NAN_RETRIES = 3


def uses_constraints(sd) -> bool:
    """True when the deck's integrator projects constraints (the
    NGLFCONSTRAINT family, RATTLE, NGLFNEW) and its topology has some."""
    uses = ("CONSTRAINT" in sd.integrator_type
            or "RATTLE" in sd.integrator_type
            or sd.integrator_type == "NGLFNEW")
    return uses and sd.bonded is not None and sd.bonded.n_constraints > 0


def deck_analyses(db: ObjectDB, sd, printinfo: PrintInfo) -> list:
    """The deck's SIMULATE analysis= objects built once, with their
    accumulators (an object that does not build warns and is skipped),
    and printStress's STRESSWRITE at printrate (simulate.py:189-221 of
    the JAX package): what Simulation and ParallelSimulation evaluate at
    the rates."""
    from ..analysis.registry import StressWrite, build_analysis
    from ..objects import DeckObject

    out = []
    for name in db.by_class("SIMULATE")[0].get_strv("analysis"):
        obj = db.find(name, "ANALYSIS")
        if obj is None:
            continue
        try:
            out.append(build_analysis(name, obj))
        except Exception as err:
            warnings.warn(f"analysis {name}: {err}", stacklevel=3)
    if printinfo.print_stress:
        rate = sd.cfg.printrate or 1
        sw = StressWrite(name="printStress",
                         obj=DeckObject("printStress", "ANALYSIS",
                                        {"type": ["STRESSWRITE"]}),
                         eval_rate=rate, output_rate=rate)
        sw.setup()
        out.append(sw)
    return out


def deck_transforms(db: ObjectDB) -> list:
    """The SIMULATE transform= list as (name, object, rate), each applied
    at the dispatch ends its rate divides (transform.c:153;
    simulate.py:216-220 of the JAX package): what Simulation and
    ParallelSimulation apply."""
    out = []
    for t in db.by_class("SIMULATE")[0].get_strv("transform"):
        tobj = db.find(t, "TRANSFORM")
        if tobj is not None:
            out.append((t, tobj, tobj.get_int("rate", 0)))
    return out


def bond_graph(bt):
    """(E, 2) rows of the topology's bonds and exclusions, which hold
    every bond, constraint and chain link, or None."""
    edges = [] if bt is None else [
        e for e in (bt.bonds, bt.exclusions) if e is not None and len(e)]
    return np.concatenate(edges).astype(np.int64) if edges else None


def whole_molecules(r, h, e, gid, pbc_mask):
    """r (n, 3) with each molecule of the bond graph e (bond_graph) made
    whole about its first bead in gid order: breadth first along the
    graph, each bead at the minimum image, on the axes pbc_mask (3,)
    marks periodic, of its parent's place.  The run's beads are wrapped
    one by one, so a molecule the box boundary cuts would tile with a
    bond ~L long in each copy."""
    a = np.concatenate([e[:, 0], e[:, 1]])
    b = np.concatenate([e[:, 1], e[:, 0]])
    n = len(r)
    # component labels: the least gid rank over the component
    rank = np.empty(n, np.int64)
    rank[np.argsort(np.asarray(gid)[:n], kind="stable")] = np.arange(n)
    label = rank.copy()
    while True:
        new = label.copy()
        np.minimum.at(new, a, label[b])
        if np.array_equal(new, label):
            break
        label = new
    L = np.diagonal(h)
    out = np.array(r, dtype=np.float64)
    placed = rank == label
    while True:
        sel = placed[a] & ~placed[b]
        if not sel.any():
            break
        child, first = np.unique(b[sel], return_index=True)
        parent = a[sel][first]
        d = r[child] - r[parent]
        out[child] = out[parent] + d - L * np.round(d / L) * pbc_mask
        placed[child] = True
    return out


def check_whole_residues(sd, tobj, new_gid):
    """Raise ValueError when the transform keeps part of a residue
    instance (by the collection's gid): the topology is instantiated over
    whole residues only."""
    col = sd.collection
    kept = np.isin(col.gid, new_gid)
    for rn, rows in sd.residue_instances:
        k = kept[rows]
        if k.any() and not k.all():
            raise ValueError(
                f"TRANSFORM {tobj.name} ({tobj.get_str('type')}) keeps "
                f"{int(k.sum())} of the {len(rows)} particles of residue "
                f"{rn} at gid {int(col.gid[rows].min())}: a particle-"
                "count change keeps whole residues only")


def host_transform(sd, tobj, r, v, mass, h, pbc_mask, *, time: float,
                   rate: int, run_dir: str, base_dir: str):
    """Apply the TRANSFORM object `tobj` on the host to the run's state
    (r, v, mass (n,), h (3, 3), f64 numpy in the collection's row order)
    with the collection's gids, species and group names
    (transforms/registry.py): a REPLICATE on a deck with a bond graph
    first makes each molecule whole (whole_molecules).  Returns (ctx,
    replicate): the TransformContext after the transform, and whether
    that whole-molecule step ran (the rebuild wraps the copies then)."""
    from ..transforms.registry import TransformContext, apply_transform

    col = sd.collection
    ctx = TransformContext(
        r=r, v=v, gid=col.gid.copy(), mass=mass,
        species_names=list(col.species_names),
        group_names=list(col.group_names), h=h)
    # what SHOCK and CUSTOM read: the time, the rate, the directories
    ctx.time = time
    ctx.dt = sd.cfg.dt
    ctx.rate = rate
    ctx.run_dir = run_dir
    ctx.base_dir = base_dir
    graph = bond_graph(sd.bonded)
    replicate = (graph is not None
                 and tobj.get_str("type").upper() == "REPLICATE")
    if replicate:
        ctx.r = whole_molecules(ctx.r, ctx.h, graph, col.gid, pbc_mask)
    apply_transform(ctx, tobj)
    return ctx, replicate


def same_particles(sd, ctx, box, ortho: bool) -> bool:
    """True when a transform's result (ctx, at the new Box `box`) keeps
    the run's particles, species and box kind (`ortho`, the live box's):
    the drivers' fast path, a re-upload of r, v and the box."""
    return (len(ctx.gid) == sd.state.n_local
            and ctx.species_names == sd.collection.species_names
            and box.ortho == ortho)


def rebuild_system(db: ObjectDB, sd, tobj, ctx, box, replicate: bool, *,
                   dtype, device):
    """A transform's count or species change into the system `sd`, with
    the JAX package's bookkeeping (simulate.py:1255-1295 there): a new
    State with masses and charges from the species (APPEND's own masses
    are not read), an unknown group name taking group 0, the
    collection's class names the old ones tiled and cut to the new count
    (after SELECTSUBSET the first n, not the kept ones), the box.  On a
    deck with a topology and a count change the topology is built anew
    over the new collection first (core/system.build_topology: residues,
    bonded terms, exclusions, chain links, constraints; the JAX package
    keeps the old one), after a REPLICATE's copies are wrapped into the
    new box; a transform that keeps part of a residue, or a residue the
    scan does not match, raises before anything changes."""
    from ..core.state import State
    from ..core.system import build_topology

    col = sd.collection
    n = sd.state.n_local
    n_new = len(ctx.gid)
    topo = None
    if sd.bonded is not None and n_new != n:
        check_whole_residues(sd, tobj, ctx.gid)
        if replicate:
            m = box.pbc_mask.cpu().numpy().astype(np.float64)
            L = np.diagonal(ctx.h)
            ctx.r = ctx.r - L * np.round(ctx.r / L) * m
        topo = build_topology(db, db.get(sd.cfg.system_name, "SYSTEM"),
                              sd.potentials, ctx.species_names, ctx.gid)
    sp_index = {s.name: s.index for s in sd.species}
    grp_index = {g.name: g.index for g in sd.groups}
    sidx = np.array([sp_index[s] for s in ctx.species_names],
                    dtype=np.int64)
    gidx = np.array([grp_index.get(g, 0) for g in ctx.group_names],
                    dtype=np.int64)
    mass = np.array([sd.species[i].mass for i in sidx])
    charge = np.array([sd.species[i].charge for i in sidx])
    sd.state = State.create(ctx.r, ctx.v, charge, mass, sidx, gidx,
                            ctx.gid, dtype=dtype, device=device)
    col.gid = ctx.gid
    col.species_names = ctx.species_names
    col.group_names = ctx.group_names
    col.class_names = (col.class_names * (n_new // max(n, 1) + 1))[:n_new]
    col.r = ctx.r
    col.v = ctx.v
    sd.box = box
    if topo is not None:
        sd.bonded, sd.residue_instances, sd.n_constraints = topo


def write_graphs_line(run_dir, loop: int, time: float, nlocal: int,
                      steps: int, cells=None, tail: str = ""):
    """Append one line to run_dir/graphs (graphWrite analog, ddcMD
    src/graph.c:23-110; simulate.py:1170-1187 of the JAX package): loop,
    time, nlocal, a cell engine's (ncell, cap, pair_slots) when `cells`
    gives them, the dispatch's steps, then `tail`."""
    line = f"{loop:10d} {time:12.6f} nlocal={nlocal}"
    if cells is not None:
        ncell, cap, pair_slots = cells
        line += f" ncell={ncell} cap={cap} pair_slots={pair_slots}"
    with open(os.path.join(run_dir, "graphs"), "a") as f:
        f.write(f"{line} steps={steps}{tail}\n")


def write_group_row(run_dir, name: str, loop: int, count: int, ke: float,
                    pe: float):
    """Append one row to run_dir/group_<name>.data (printinfo.c:261-279;
    simulate.py:1189-1211 of the JAX package): loop, members, T =
    2 ke / (3 count kB), kinetic and potential energy a member, from the
    group's summed ke and pe."""
    T = 2.0 * ke / (3.0 * count * U.kB)
    with open(os.path.join(run_dir, f"group_{name}.data"), "a") as f:
        f.write(f"{loop:12d} {count:10d} {T:14.4f} {ke / count:16.8f} "
                f"{pe / count:16.8f}\n")


def resolve_device(device=None) -> torch.device:
    """The device a run uses: `device` when given, else the CUDA card.
    Without a card a run raises: the CPU runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: pass device="cpu" (the CLI\'s --device '
                'cpu) to run on the CPU')
        device = "cuda"
    return torch.device(device)


def refuse_shear_tilt(sd):
    """SHEAR / SHWALL slabs live in Cartesian z (shear.c), as in the JAX
    package (simulate.py:108-117): a box whose c vector is coupled to z
    by a tilt raises NotImplementedError (an xy tilt is fine).  Simulation
    and ParallelSimulation both check it."""
    h = sd.box.h.cpu().numpy()
    if any(g.type in ("SHEAR", "SHWALL") for g in sd.groups) and \
            np.any(h[[2, 2, 0, 1], [0, 1, 2, 2]] != 0):
        raise NotImplementedError(
            "SHEAR/SHWALL need the c lattice vector along z (xy tilt "
            "is fine; z-coupled tilt is not)")


def dynamic_box(sd) -> bool:
    """True when the box moves: a barostat's beta > 0, NPTGLF, NGLFNK or a
    prescribed box(t) (the JAX package's dyn_box)."""
    return (sd.box_time is not None or sd.integrator_type in _NPT_TYPES
            or sd.integrator_parms["beta"] > 0)


def piston_start(db: ObjectDB, sd):
    """(zeta, bdot) at the start of a run: NPTGLF's zeta and NGLFNK's
    piston velocities from the deck (a restart file merges its values
    into the INTEGRATOR object), 0 for the other integrators; floats and
    a (3,) f64 array."""
    itype = sd.integrator_type
    zeta0 = sd.integrator_parms["zeta"] if itype == "NPTGLF" else 0.0
    bdot0 = np.zeros(3)
    if itype == "NGLFNK":
        bdot0 = db.get(sd.cfg.integrator_name, "INTEGRATOR") \
            .get_with_unitsv("bdot", "0 0 0", "l/t")
    return float(zeta0), np.asarray(bdot0, dtype=np.float64)


def nglfnk_h_frac(sd):
    """NGLFNK's fixed cell shape: None for an orthorhombic start box, else
    its unit lattice vectors h0 / |h0 columns| (h = h_frac diag(L))."""
    if sd.box.ortho:
        return None
    h0 = sd.box.h.cpu().numpy().astype(np.float64)
    return h0 / np.linalg.norm(h0, axis=0)[None, :]


def global_energy_groups(sd) -> dict:
    """{group index: group} of the LANGEVIN groups whose Teq follows the
    energy (Teq_dynamics=GLOBAL_ENERGY)."""
    return {g.index: g for g in sd.group_table.groups
            if g.parms.get("teq_dynamics") == "GLOBAL_ENERGY"}


def refreshes_coefficients(sd) -> bool:
    """True when a run refreshes the group coefficients once a dispatch:
    a Teq or PISTON vz schedule, or a GLOBAL_ENERGY target, under an
    integrator that reads them (the NVE variants do not)."""
    gt = sd.group_table
    return ((gt.time_dependent or bool(global_energy_groups(sd)))
            and sd.integrator_type not in _NVE_TYPES)


def global_energy_teq(ge_groups: dict, ge_total: dict, e, n_global: int):
    """Live Teq of each GLOBAL_ENERGY Langevin group: the conserved bath +
    system energy is pinned (into ge_total) at the first potential
    energy the host reads, then Teq = (total - E)/(Cp N)
    (langevin_getTemperature, src/langevin.c:31-51; simulate.py:249-263
    of the JAX package), E the last step's energy.  None without such
    groups or without a finite E."""
    if not ge_groups or e is None or not np.isfinite(e):
        return None
    out = {}
    for i, g in ge_groups.items():
        cp_n = g.parms["Cp"] * n_global
        if i not in ge_total:
            ge_total[i] = float(g.Teq(0.0)) * cp_n + e
        out[i] = (ge_total[i] - e) / cp_n
    return out


def live_coefficients(sd, time: float, dtype, device, teq_override=None):
    """GroupTable.coefficients at `time` with the live GLOBAL_ENERGY
    targets (teq_override); the NVE variants ignore thermostats and kick
    with plain leapfrog coefficients (nveglf.c; simulate.py:331-337 of
    the JAX package)."""
    c = sd.group_table.coefficients(time, 0.5 * sd.cfg.dt, dtype=dtype,
                                    device=device, teq_override=teq_override)
    if sd.integrator_type in _NVE_TYPES:
        a, c_on, noise, vcm, kind, ber = c
        c = (torch.ones_like(a), torch.ones_like(c_on),
             torch.zeros_like(noise), torch.zeros_like(vcm),
             torch.zeros_like(kind), torch.zeros_like(ber))
    return c


def box_time_factors(bt: dict, time: float, dt: float, n_steps: int,
                     volume: float, n_global: int):
    """The prescribed box(t) of the next n_steps steps as (E, M), each
    (n_steps, 3, 3) f64 on the host: step i of the dispatch sets h =
    (E[i] * h0) @ M[i], h0 the dispatch's first box
    (boxPrescriptiveTime.c:96-145; simulate.py:1134-1170 of the JAX
    package, whose per-step factors are constant across a dispatch:
    E[i], M[i] are their i+1-th powers, taken in f64, so E[0], M[0] are
    the one-step factors).  STRAIN fills E elementwise, DEFORMATION_RATE
    fills M = expm(D dt), VOLUME a uniform E that reaches n Veq(t + S
    dt) at the dispatch's end from the volume at its start."""
    S = max(1, n_steps)
    steps = np.arange(1, S + 1, dtype=np.float64)[:, None, None]
    E = np.ones((S, 3, 3))
    M = np.broadcast_to(np.eye(3), (S, 3, 3)).copy()
    if bt["mode"] == "strain":
        log_e = np.array([[eq.integral(time, time + S * dt) / S
                           for eq in row] for row in bt["eqs"]])
        E = np.exp(steps * log_e[None])
    elif bt["mode"] == "deformation":
        D = np.asarray(bt["D"], dtype=np.float64) * dt
        step = np.eye(3)
        term = np.eye(3)
        for k in range(1, 24):                # expm series (exact to
            term = term @ D / k               # machine eps for D dt<<1)
            step = step + term
            if np.abs(term).max() < 1e-18:
                break
        for i in range(S):
            M[i] = (M[i - 1] if i else np.eye(3)) @ step
    else:  # volume: n Veq(t + S dt) exactly at the dispatch's end
        v_tgt = n_global * float(bt["eq"](time + S * dt))
        E = E * np.exp(steps * math.log(v_tgt / volume) / (3.0 * S))
    return E, M


def choose_engine(sd, dtype, engine: str = "auto") -> str:
    """The engine of a deck, as the JAX package's auto choice on a TPU
    (simulate.py:50-118) with "pallas" read as "kernel":

      * "nlist" for a deck with PAIRENERGY or ORDERSH, and (with a
        warning) for a deck whose exclusion graph has a component wider
        than the cell engines' 12-member encoding;
      * "cellblock" when the deck forces it (pbc < 7, a triclinic box,
        f64, an EAM term the EAM kernels do not take: TABULAR without
        tabularFit=rational, more than 4 species);
      * "kernel" otherwise.

    A PAIR TableFunction raises under auto, naming engine="nlist" (the
    JAX cell engines give it zero pair force).  An explicit engine is
    kept: "nlist" runs any deck; a cell engine raises ValueError for a
    list-only term or a wide exclusion component (and NotImplementedError
    for a table), and "kernel" on a deck that forces the cell-block
    engine raises instead of moving off the kernels unasked."""
    eam = [p[2] for p in sd.potentials if p[0] == "EAM"]
    forced = [why for why, yes in (
        (f"dtype {dtype}", dtype != torch.float32),
        (f"pbc={sd.box.pbc}", sd.box.pbc & 7 != 7),
        ("a triclinic box", not sd.box.ortho),
        *((f"EAM form {p.form} with {p.n_species} species",
           not eam_half_supported(vars(p))) for p in eam)) if yes]
    list_only = [f"{p[0]} ({p[1]})" for p in sd.potentials
                 if p[0] in ("PAIRENERGY", "ORDERSH")]
    wide = wide_exclusion_component(sd)
    table = any(p[0] == "PAIR" and p[2].table is not None
                for p in sd.potentials)
    if engine == "auto":
        if list_only:
            return "nlist"
        if wide:
            cell = "cellblock" if forced else "kernel"
            warnings.warn(
                "exclusion graph exceeds the in-kernel encoding "
                f"({wide}-member component); demoting {cell} -> nlist "
                "engine for exclusion safety", stacklevel=3)
            return "nlist"
        if table:
            raise NotImplementedError(TABLE_ENGINE)
        return "cellblock" if forced else "kernel"
    if engine not in ("kernel", "cellblock", "nlist"):
        raise ValueError(f"engine {engine!r}: auto, kernel, cellblock or "
                         "nlist")
    if engine == "nlist":
        return engine
    if list_only:
        raise ValueError(
            f"engine {engine!r} cannot run {', '.join(list_only)}: these "
            'terms run on the (N,K)-list engine only (engine "nlist")')
    if wide:
        raise ValueError(
            f"engine {engine!r}: an exclusion component of {wide} particles "
            "exceeds what the cell engines' in-kernel exclusion channels "
            'encode; the deck runs on engine "nlist"')
    if table:
        raise NotImplementedError(TABLE_ENGINE)
    if engine == "kernel" and forced:
        raise ValueError(
            f"engine 'kernel' cannot run {', '.join(forced)}: the kernels "
            "take f32, orthorhombic, fully periodic decks, and EAM in the "
            "analytic forms or the tabularFit=rational refit with 1-4 "
            "species")
    return engine


class Simulation:
    """Owns the force and step functions and the host loop."""

    def __init__(self, db: ObjectDB, base_dir: str = ".", *,
                 run_dir: str = ".", device=None, dtype=torch.float32,
                 engine: str = "auto"):
        self.device = resolve_device(device)
        # the deck's objects and directory: the command file's object
        # text is compiled into db and rescanned, NEXTFILE reads its
        # files relative to base_dir
        self.db = db
        self.base_dir = base_dir
        self.run_dir = run_dir
        self.dtype = dtype
        self.sysdef = sd = build_system(db, base_dir, dtype=dtype,
                                        device=self.device)
        self.printinfo = PrintInfo.from_deck(db, sd.cfg.printinfo_name)
        # the SIMULATE analysis= list, each evaluated and written at its
        # rates (masters.c:295-302), and PRINTINFO printStress's STRESSWRITE
        # at printrate (printinfo.c:241-260); an analysis whose setup
        # fails is skipped with a warning, as in the JAX package
        # (simulate.py:189-215).  They outlive a count change (_derive)
        self.analyses = deck_analyses(db, sd, self.printinfo)
        # the SIMULATE transform= list, (name, object, rate): each applied
        # at the dispatch ends its rate divides (transform.c:153;
        # simulate.py:216-220 of the JAX package)
        self.transforms = deck_transforms(db)
        refuse_shear_tilt(sd)
        self.post_drift_fn = None
        if any(p[0] == "REFLECT" for p in sd.potentials):
            from ..potentials.reflect import reflect

            self.post_drift_fn = reflect
        # dynamic boxes plan with shrink headroom (simulate.py:120-128)
        self._dyn_box = dynamic_box(sd)
        self._plan_margin = 1.08 if self._dyn_box else 1.0
        self._density_safety = 1.3
        self._engine_request = engine
        self._eion_last = None
        self._derive(sd.box, sd.cfg.time)
        self._generator = torch.Generator(device=self.device)
        self._forced_spr = None
        self._forced_dispatch = None
        self._clean_disp = 0
        # counts of discarded dispatches, by cause (nan: the rollback's
        # retries)
        self.redos = {"stale": 0, "overflow": 0, "nan": 0}
        self._blowup_dumped = False
        # (steps, seconds) of each accepted dispatch, host clock around
        # work that ends in the dispatch's one device sync
        self.dispatch_log: list[tuple[int, float]] = []
        zeta0, bdot0 = piston_start(db, sd)
        self.ss = StepState(
            state=sd.state, box=sd.box,
            energy=EnergyInfo.zero(dtype=dtype, device=self.device),
            loop=sd.cfg.loop, time=sd.cfg.time,
            zeta=torch.tensor(zeta0, dtype=dtype, device=self.device),
            bdot=torch.as_tensor(bdot0, dtype=dtype, device=self.device))

    # ------------------------------------------------------------------

    def _derive(self, box, time: float):
        """What the run derives from its particles and box: the engine
        (choose_engine; the kernel a plan takes depends on its cell
        count), the molecule class and the barostat's molecule count, the
        constraint projector, the cell plan at `box`, the force function
        and the step, and the group coefficients at `time` (the
        GLOBAL_ENERGY totals are pinned anew at the next energy).  Run
        when the Simulation is built and after a transform changed the
        particle count or the species (apply_transform)."""
        sd = self.sysdef
        ip = sd.integrator_parms
        self.engine = choose_engine(sd, self.dtype, self._engine_request)
        sysobj = self.db.get(sd.cfg.system_name, "SYSTEM")
        self.molecules = build_molecule_class(
            self.db, sysobj, sd.collection.species_names, sd.collection.gid)
        self.n_molecules = (self.molecules.n_molecules if self.molecules
                            else sd.state.n_local)
        # the Berendsen barostat belongs to the constraint integrators;
        # plain NGLF ignores beta, as the reference's nglf.c does
        self.barostat = None
        if sd.integrator_type in _BAROSTAT_TYPES and ip["beta"] > 0:
            self.barostat = dict(P0=ip["P0"], beta=ip["beta"],
                                 tau=ip["tauBarostat"], T=ip["T"],
                                 isotropic=ip["isotropic"],
                                 n_molecules=self.n_molecules)
        self.mol_virial_fn = make_molecular_virial_fn(
            self.molecules, dtype=self.dtype, device=self.device)
        self.constraint_fn = self._make_constraint_fn()
        self.grid = self._plan(box)
        self._build_step()
        self._ge_total: dict = {}
        self._group_setup(time)

    def _group_setup(self, time: float):
        """The group kick's coefficients at `time` and what refreshes
        them: energy-feedback targets (Teq_dynamics=GLOBAL_ENERGY,
        langevin.c:31-51) and Teq / PISTON vz schedules are refreshed at
        every dispatch from the last potential energy the host holds.
        Called when the Simulation is built and after the command file's
        object rescan (a CONSTANT Teq may have become a ramp)."""
        self._ge_groups = global_energy_groups(self.sysdef)
        self._refresh_coeffs = refreshes_coefficients(self.sysdef)
        self._union_draws = self.sysdef.group_table.union_draws
        self.coeffs = self._coefficients(time)

    def _coefficients(self, time: float):
        """live_coefficients at `time` with the live GLOBAL_ENERGY
        targets."""
        return live_coefficients(self.sysdef, time, self.dtype, self.device,
                                 self._ge_teq_override())

    def _make_constraint_fn(self):
        """Residue-template batched RATTLE when the topology allows it in
        an orthorhombic box (every Martini deck), the generic projector
        otherwise (simulate.py:265-295); both take the live geometry per
        call."""
        sd = self.sysdef
        bt = sd.bonded
        if not uses_constraints(sd):
            return None
        from ..integrators.constraints import (build_constraint_fn,
                                               build_constraint_fn_batched)

        L = sd.box.lengths.cpu().numpy().astype(np.float64)
        fn = None
        if sd.box.ortho:
            fn = build_constraint_fn_batched(
                bt.cons_atoms, bt.cons_pairs, bt.cons_dist, sd.state.n_pad,
                self.dtype, sd.residue_instances, box_lengths=L,
                device=self.device)
        if fn is None:
            fn = build_constraint_fn(
                bt.cons_atoms, bt.cons_pairs, bt.cons_dist, sd.state.n_pad,
                self.dtype, box_lengths=L, device=self.device)
        return fn

    def _plan(self, box):
        """The engine's cell plan at `box`: plan_lanes for the kernels,
        CellBlockGrid.plan (perpendicular spans) for the cell-block
        engine, plan_grid (perpendicular spans) for the list."""
        sd = self.sysdef
        if self.engine == "nlist":
            return plan_grid(sd, plan_margin=self._plan_margin, box=box)
        geom = box.geom.cpu().numpy().astype(np.float64)
        if self.engine == "kernel":
            return plan_lanes(geom, sd.rcut_max, sd.neighbor_deltaR,
                              sd.state.n_local,
                              density_safety=self._density_safety,
                              plan_margin=self._plan_margin)
        return CellBlockGrid.plan(geom, sd.rcut_max, sd.neighbor_deltaR,
                                  sd.state.n_local,
                                  plan_margin=self._plan_margin)

    def _build_step(self):
        """The force function on the current plan and the integrator's
        step (simulate.py:264-355 of the JAX package): NPTGLF, NGLFNK
        (orthorhombic, or the fixed-shape triclinic piston with h =
        h_frac diag(L), h_frac the start box's unit lattice vectors), or
        the NGLF step with the hook groups and the BERENDSEN rescale."""
        sd = self.sysdef
        ip = sd.integrator_parms
        gt = sd.group_table
        self.force_fn = build_force_fn(sd, self.grid, self.dtype,
                                       self.engine)
        wrap = self.engine == "nlist"
        if sd.integrator_type == "NPTGLF":
            self.step_fn = make_nptglf_step(
                self.force_fn, sd.cfg.dt, n_global=sd.state.n_local,
                Gamma=ip["Gamma"], Peq=ip["pressure"], wrap_positions=wrap,
                has_berendsen=gt.has_berendsen)
        elif sd.integrator_type == "NGLFNK":
            self.step_fn = make_nglfnk_step(
                self.force_fn, sd.cfg.dt, T=ip["T"], tau=ip["tau"],
                Peq=ip["P"], W=ip["W"], kB=U.kB, wrap_positions=wrap,
                h_frac=nglfnk_h_frac(sd))
        else:
            self.step_fn = make_nglf_step(
                self.force_fn, sd.cfg.dt, barostat=self.barostat,
                constraint_fn=self.constraint_fn,
                molecular_virial_fn=self.mol_virial_fn,
                post_drift_fn=self.post_drift_fn, wrap_positions=wrap,
                has_berendsen=gt.has_berendsen,
                shear_groups=gt.shear_groups)
        # the cell-edge guard's per-axis bound, made once per plan
        self._edge_min = (torch.tensor(self.grid.ncells, dtype=self.dtype,
                                       device=self.device)
                          * float(self.grid.rlist))

    def _room(self):
        """The plan's capacities: the cell cap, and the list's K."""
        g = self.grid
        if self.engine == "nlist":
            return (g.cell_capacity, g.max_neighbors)
        return g.cap

    def replan(self):
        """Re-plan the cell grid at the live box (and, for the kernels,
        the current density safety); the cap (and the list's K) never
        shrinks (the overflow ladder only grows it)."""
        prev = self.grid
        self.grid = self._plan(self.ss.box)
        if self.engine == "nlist":
            self.grid = dataclasses.replace(
                self.grid,
                cell_capacity=max(self.grid.cell_capacity,
                                  prev.cell_capacity),
                max_neighbors=max(self.grid.max_neighbors,
                                  prev.max_neighbors))
        elif self.grid.cap < prev.cap:
            self.grid = self.grid.with_cap(prev.cap)
        self._build_step()

    def _grid_stale(self, slack: float = 1.0) -> bool:
        """True when the live box has shrunk a cell edge below
        slack * rlist: the cell plan itself must change."""
        spans = self.ss.box.perp_spans.cpu().numpy().astype(np.float64)
        return bool(np.any(spans / np.asarray(self.grid.ncells)
                           < self.grid.rlist * slack))

    def _build_nbr(self, ss: StepState):
        """The cell engines wrap at rebuild (steps between rebuilds leave
        positions unwrapped so the cell-block image shifts stay exact)
        and bin into slots; the list engine builds the (N,K) list from
        the positions its steps wrapped, with the deck's pbc bits.  The
        overflow flag also covers a live cell edge below rlist (a
        shrinking box with a static cell count misses one-shell pairs)."""
        edge_bad = torch.any(ss.box.perp_spans < self._edge_min)
        if self.engine == "nlist":
            nbr, _, overflow = build_neighbor_list(
                ss.state.r, ss.state.fmask, ss.box.geom, self.grid,
                pbc=ss.box.pbc)
            return ss, nbr, overflow | edge_bad
        r = ss.box.back_in_box(ss.state.r)
        ss = ss.replace(state=ss.state.replace(r=r))
        perm, overflow = build_cell_slots(r, ss.state.fmask, ss.box.geom,
                                          self.grid)
        return ss, perm, overflow | edge_bad

    def _energy_at(self, ss: StepState) -> StepState:
        """Rebuild plus forces and energies at ss (firstEnergyCall); a
        silent overflow would return energies from a dropped-pair list,
        so the flag is checked and the grid replanned as the run loop
        does."""
        for _ in range(10):
            ss2, perm, ov = self._build_nbr(ss)
            if not bool(ov):
                return first_energy_call(ss2, self.force_fn, perm)
            self._replan_after_overflow()
        raise RuntimeError(
            "neighbor overflow persists in first_energy after repeated "
            "replans")

    def first_energy(self) -> StepState:
        self.ss = self._energy_at(self.ss)
        if self._ge_groups:
            self._eion_last = float(self.ss.energy.eion)
        return self.ss

    def _replan_after_overflow(self):
        """A moving box replans at the live box first (a compression that
        took a cell edge below rlist needs a new cell plan, a denser box a
        new occupancy plan); when that changes nothing, or the box never
        moved, the kernels' density safety grows by 1.3 before the
        replan, the cell-block engine's cap by 1.5, the list's cell
        capacity by 1.5 (to a multiple of 8) and its K by 1.5 (to a
        multiple of 128) (recapacity, simulate.py:611-641)."""
        if self._dyn_box or self._grid_stale(slack=1.05):
            old = (self.grid.ncells, self._room())
            self.replan()
            if (self.grid.ncells, self._room()) != old:
                return
        if self.engine == "nlist":
            g = self.grid
            self.grid = dataclasses.replace(
                g, cell_capacity=((int(g.cell_capacity * 1.5) + 7) // 8) * 8,
                max_neighbors=((int(g.max_neighbors * 1.5) + 127) // 128)
                * 128)
            self._build_step()
            return
        if self.engine == "cellblock":
            self.grid = self.grid.with_cap(int(self.grid.cap * 1.5))
            self._build_step()
            return
        self._density_safety *= 1.3
        self.replan()

    def _noise(self, step: int, attempt: int = 0):
        """The step's two kick draws (2, n_pad, 3) -- NGLFNK's g1 and g2
        -- and, with UNIONGROUPs, the member draws (2, members, n_pad, 3)
        at their own callsites, or None; `attempt`: the NaN rollback's
        retry of the dispatch (0 otherwise)."""
        shape = (2, self.ss.state.n_pad, 3)
        seed = self.sysdef.random_seed
        noise = kick_noise(self._generator, seed, step, _NOISE_CALLSITE_NGLF,
                           shape, dtype=self.dtype, attempt=attempt)
        if not self._union_draws:
            return noise, None
        return noise, torch.stack([
            kick_noise(self._generator, seed, step, union_callsite(g, j),
                       shape, dtype=self.dtype, attempt=attempt)
            for g, j in self._union_draws], dim=1)

    def _ge_teq_override(self):
        """global_energy_teq from E, the last step's energy of the previous
        dispatch's rows (or the first energy), so the refresh reads
        nothing from the device."""
        return global_energy_teq(self._ge_groups, self._ge_total,
                                 self._eion_last, self.sysdef.state.n_local)

    def _box_lam(self, n_steps: int):
        """box_time_factors of the next n_steps steps from the live time
        and volume, as (E, M) on the device; None without a box(t)."""
        bt = self.sysdef.box_time
        if bt is None:
            return None
        volume = (float(self.ss.box.volume) if bt["mode"] == "volume"
                  else 0.0)
        E, M = box_time_factors(bt, self.ss.time, self.sysdef.cfg.dt,
                                n_steps, volume, self.sysdef.state.n_local)
        return self._dev(E), self._dev(M)

    def _dispatch(self, ss: StepState, n_rebuilds: int, spr: int,
                  box_lam=None, attempt: int = 0):
        """n_rebuilds * spr steps with no host sync until the end
        (box_lam: the _box_lam of these steps, or None; attempt: the
        noise's, see _noise).  Returns (ss, rows (k, len(_ROW)) as
        numpy, overflow, worst displacement plus twice the box motion of
        a step whose list was reused)."""
        dev = self.device
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        worst = torch.zeros((), dtype=self.dtype, device=dev)
        rows = []
        vrows = []
        h_start = ss.box.h
        for j in range(n_rebuilds):
            ss, perm, ov = self._build_nbr(ss)
            overflow = overflow | ov
            r0, h0 = ss.state.r, ss.box.h
            fmask = ss.state.fmask
            for i in range(spr):
                noise, draws = self._noise(ss.loop, attempt)
                lam = None
                if box_lam is not None and self.barostat is not None:
                    # the barostat rescales the box every step: the
                    # one-step factors go onto the live box, as in the
                    # JAX package, so neither undoes the other
                    lam = (box_lam[0][0], box_lam[1][0], None)
                elif box_lam is not None:
                    lam = (box_lam[0][j * spr + i], box_lam[1][j * spr + i],
                           h_start)
                ss = self.step_fn(ss, perm, self.coeffs, noise[0], noise[1],
                                  box_lam=lam, draws=draws)
                if i < spr - 1:
                    # staleness only matters if more steps use this list;
                    # box motion since the rebuild counts too (a moving
                    # box moves boundary-wrapped particles by ~|dh|)
                    dr = ss.box.min_image(ss.state.r - r0)
                    md2 = torch.max((dr * dr).sum(dim=1) * fmask)
                    eff = torch.sqrt(md2)
                    if self._dyn_box:
                        eff = eff + 2.0 * torch.max(torch.abs(ss.box.h - h0))
                    worst = torch.maximum(worst, eff)
                e = ss.energy
                L = ss.box.lengths
                # the hottest particle's |v| and row, one reduction (the
                # padded rows' velocities are 0)
                vmax, vrow = torch.max(
                    torch.linalg.vector_norm(ss.state.v, dim=1), dim=0)
                rows.append(torch.stack([e.eion, e.rk, torch.trace(e.virial),
                                         torch.trace(e.tion), ss.box.volume,
                                         L[0], L[1], L[2], vmax]))
                vrows.append(vrow)
        k = len(rows)
        flags = torch.stack([overflow.to(self.dtype), worst])
        host = torch.cat([torch.stack(rows).reshape(-1),
                          torch.stack(vrows).to(self.dtype), flags]).cpu()
        host = host.numpy().astype(np.float64)
        out = np.empty((k, len(_ROW)))
        out[:, :9] = host[:9 * k].reshape(k, 9)
        out[:, 8] **= 2
        out[:, 9] = host[9 * k:10 * k]
        return ss, out, bool(host[-2]), float(host[-1])

    def run(self, n_loops: int | None = None, *, print_fn=None,
            on_checkpoint=None, max_seconds: float | None = None,
            max_steps_per_dispatch: int = 400) -> StepState:
        """Run the MD loop; returns the final StepState.  With
        on_checkpoint (called with the Simulation) set, checkpoints are
        written at the deck's checkpointrate and snapshots (atoms + bxyz)
        at its snapshotrate, as the JAX package's run loop does.  The
        analyses evaluate at the dispatch ends their eval_rate divides
        and write at those their outputrate divides; every dispatch ends
        on each of these rates' next multiple (the JAX package's cap can
        step over one).  The run stops early when `ddcMD_CMDS` says exit,
        kill or stop, or after the first dispatch that ends past
        max_seconds of wall time; either way every analysis writes its
        output once more at the end (simulate.py:1130-1131 of the JAX
        package).  The NEXTFILE and NGLFTEST / NGLFERROR integrators run
        their masters instead (n_loops does not apply)."""
        sd = self.sysdef
        cfg = sd.cfg
        if sd.integrator_type == "NEXTFILE":
            return self.run_nextfile(print_fn)
        if sd.integrator_type in ("NGLFTEST", "NGLFERROR"):
            return self.run_nglftest(print_fn)
        if n_loops is None:
            n_loops = (cfg.deltaloop if cfg.deltaloop
                       else cfg.maxloop - self.ss.loop)
        update_rate = max(1, cfg.ddc_update_rate)
        self.first_energy()
        done = 0
        ov_retries = 0
        # NaN retries of the current dispatch; its noise draws at
        # attempt = retries, which a stale redo keeps
        retries = 0
        t_start = _time.monotonic()
        while done < n_loops:
            k = min(n_loops - done, max_steps_per_dispatch,
                    self._forced_dispatch or n_loops)
            for rate in (cfg.checkpointrate, cfg.snapshotrate):
                if on_checkpoint and rate:
                    k = min(k, rate - self.ss.loop % rate)
            for rate in self._host_rates():
                # a dispatch ends on each transform's and each analysis's
                # next multiple (the JAX package only caps the dispatch at
                # the rate, simulate.py:884-889, so a dispatch of whole
                # rebuild blocks can step over a multiple: loop 30 at rate
                # 30 on a 20-step cadence)
                k = min(k, rate - self.ss.loop % rate)
            spr = min(update_rate, self._forced_spr or update_rate)
            if k >= spr:
                n_rebuilds = k // spr
            else:
                spr, n_rebuilds = k, 1
            k = n_rebuilds * spr
            if self._refresh_coeffs:
                # Teq schedules, PISTON vz(t) and GLOBAL_ENERGY targets
                # (simulate.py:169-184 of the JAX package)
                self.coeffs = self._coefficients(self.ss.time)
            t0 = _time.perf_counter()
            with PROFILE.phase("loop"):
                ss_new, rows, overflow, worst = self._dispatch(
                    self.ss, n_rebuilds, spr, self._box_lam(k), retries)
            seconds = _time.perf_counter() - t0
            PROFILE.count("md_steps", k)
            if overflow:
                ov_retries += 1
                self.redos["overflow"] += 1
                self._clean_disp = 0
                if ov_retries > 8:
                    raise RuntimeError(
                        "neighbor overflow persists after repeated replans "
                        f"(loop {self.ss.loop})")
                if self._dyn_box and ov_retries >= 3:
                    # a compression faster than one dispatch: advance in
                    # shorter dispatches so the replans follow the box
                    self._forced_dispatch = max(spr, k // 2)
                self._replan_after_overflow()
                continue
            ov_retries = 0
            bad = ~np.isfinite(rows[:, 0] + rows[:, 1])
            if bad.any():
                retries += 1
                self._nan_rollback(rows, bad, k, n_rebuilds, spr, retries)
                continue
            if 2.0 * worst >= sd.neighbor_deltaR and spr > 1:
                warnings.warn(
                    f"neighbor list went stale (2*max_disp={2 * worst:.3f} "
                    f"nm >= deltaR={sd.neighbor_deltaR}); halving rebuild "
                    "cadence and redoing the dispatch", stacklevel=2)
                self.redos["stale"] += 1
                self._forced_spr = max(1, spr // 2)
                self._clean_disp = 0
                continue
            retries = 0
            if self._forced_spr is not None or \
                    self._forced_dispatch is not None:
                self._clean_disp += 1
                if self._clean_disp >= 8:
                    self._clean_disp = 0
                    if self._forced_spr is not None:
                        fs = 2 * self._forced_spr
                        self._forced_spr = None if fs >= update_rate else fs
                    if self._forced_dispatch is not None:
                        fd = 2 * self._forced_dispatch
                        self._forced_dispatch = (
                            None if fd >= max_steps_per_dispatch else fd)
            self.ss = ss_new
            self._eion_last = float(rows[-1, 0])
            done += k
            self.dispatch_log.append((k, seconds))
            with PROFILE.phase("printinfo"):
                self._emit_prints(rows, k, print_fn)
            if self.printinfo.print_graphs:
                self._emit_graphs(k)
            if len(sd.groups) > 1 and cfg.printrate \
                    and self.ss.loop % cfg.printrate == 0:
                self._emit_group_files()
            loop = self.ss.loop
            for a in self.analyses:
                ev = a.eval_rate and loop % a.eval_rate == 0
                out = a.output_rate and loop % a.output_rate == 0
                if ev or out:
                    with PROFILE.phase("analysis"):
                        if ev:
                            a.eval(self)
                        if out:
                            a.output(self, self.run_dir)
            for _, tobj, rate in self.transforms:
                if rate and loop % rate == 0:
                    self.apply_transform(tobj)
            if on_checkpoint and cfg.checkpointrate \
                    and self.ss.loop % cfg.checkpointrate == 0:
                on_checkpoint(self)
            if on_checkpoint and cfg.snapshotrate \
                    and self.ss.loop % cfg.snapshotrate == 0:
                from ..io.restart import write_snapshot

                write_snapshot(self, self.run_dir)
            if self._poll_commands(on_checkpoint):
                break
            if max_seconds is not None \
                    and _time.monotonic() - t_start > max_seconds:
                break
        for a in self.analyses:
            a.output(self, self.run_dir)
        return self.ss

    def _host_rates(self) -> list[int]:
        """The non-zero rates at which the host acts between dispatches:
        each transform's, each analysis's eval_rate and outputrate."""
        rates = [rate for _, _, rate in self.transforms]
        for a in self.analyses:
            rates += [a.eval_rate, a.output_rate]
        return [r for r in rates if r]

    def _nan_rollback(self, rows, bad, k, n_rebuilds, spr, retries):
        """A dispatch whose rows hold a non-finite energy is discarded:
        self.ss is still the pre-dispatch state, and the run loop redoes
        the dispatch with fresh noise (saveState/restoreState, ddcMD
        src/saveState.c:45,117; masters.c:461-466).  Warns with the first
        bad step, the dispatch, the last good row and the hottest
        particle's history; with DDCMD_BLOWUP_DUMP set, the first NaN
        writes the pre-dispatch checkpoint and an .npz of the dispatch's
        noise key (seed, first loop, attempt) and the hot-particle trace
        (simulate.py:1013-1072 of the JAX package).  After _NAN_RETRIES
        retries, writes the pre-dispatch state as a checkpoint without
        moving the `restart` link and raises the kill switch
        (masters.c:470-475)."""
        from ..io.restart import write_checkpoint

        loop0 = self.ss.loop
        i_bad = int(np.argmax(bad))
        last_ok = rows[max(0, i_bad - 1)]
        # trace the runaway back: the first step whose hottest particle
        # exceeded ~30x the thermal velocity names the injection point
        v2 = rows[:i_bad + 1, 8]
        v2_ref = float(np.median(v2[:max(1, i_bad // 2)]))
        hot_steps = np.nonzero(v2 > 1e3 * max(v2_ref, 1e-12))[0]
        j0 = int(hot_steps[0]) if len(hot_steps) else i_bad
        warnings.warn(
            f"non-finite energy at step {loop0 + i_bad + 1} (chunk {loop0}"
            f"+{k}, in-chunk index {i_bad}; last good row e="
            f"{last_ok[0]:.4g} rk={last_ok[1]:.4g} vol={last_ok[4]:.4g}); "
            f"vmax2 {v2[max(0, j0 - 1)]:.3g}->{v2[j0]:.3g} at in-chunk step "
            f"{j0}, atom row {int(rows[j0, 9])}; rollback retry "
            f"{min(retries, _NAN_RETRIES)}/{_NAN_RETRIES}", stacklevel=3)
        dump = os.environ.get("DDCMD_BLOWUP_DUMP")
        if dump and not self._blowup_dumped:
            # the pre-dispatch checkpoint and the dispatch's noise key
            # (kick_noise of (seed, step, callsite, attempt) for steps
            # loop0 + 1 ...) make the blowup replayable
            self._blowup_dumped = True
            snap = write_checkpoint(self, self.run_dir, update_symlink=False)
            np.savez(dump, seed=self.sysdef.random_seed, loop0=loop0,
                     attempt=retries - 1, n_rebuilds=n_rebuilds, spr=spr,
                     bad=i_bad, hot_step=j0, hot_row=int(rows[j0, 9]),
                     snapdir=snap, vmax2=v2, vrow=rows[:i_bad + 1, 9])
            print(f"blowup forensic dump: {snap} + {dump}")
        if retries > _NAN_RETRIES:
            snap = write_checkpoint(self, self.run_dir, update_symlink=False)
            print(f"kill-switch state dumped to {snap}")
            raise FloatingPointError(
                f"non-finite energy at loop {loop0 + i_bad + 1} after "
                f"{_NAN_RETRIES} retries (reference kill switch, "
                "masters.c:470-475)")
        self.redos["nan"] += 1

    def _emit_graphs(self, k: int):
        """One graphs line a dispatch (write_graphs_line): the cell
        engines' cell count, cap and the pair slots their sweep covers
        (plan_lanes gives both packages' kernel plans)."""
        g = self.grid
        cells = ((g.ncell, g.cap, g.ncell * g.n_stencil * g.cap * g.cap)
                 if hasattr(g, "cap") else None)
        write_graphs_line(self.run_dir, self.ss.loop, self.ss.time,
                          self.sysdef.state.n_local, k, cells)

    def _emit_group_files(self):
        """Per-group temperature and energies (write_group_row)."""
        sd = self.sysdef
        n = sd.state.n_local
        st = self.ss.state

        def host(x):
            return x[:n].detach().cpu().numpy().astype(np.float64)

        v, m, pe = host(st.v), host(st.mass), host(st.pe)
        gids = st.group[:n].cpu().numpy()
        for g in sd.groups:
            sel = gids == g.index
            cnt = int(sel.sum())
            if cnt == 0:
                continue
            ke = 0.5 * (m[sel, None] * v[sel] ** 2).sum()
            write_group_row(self.run_dir, g.name, self.ss.loop, cnt, ke,
                            pe[sel].sum())

    def apply_transform(self, tobj):
        """Apply the TRANSFORM object `tobj` to the run's state on the host
        (transforms/registry.py) and re-upload it, then the first energy
        (transform.c:153-181; simulate.py:1213-1296 of the JAX package).

        Fast path, the same particles and species: r and v replace the
        state's and the box takes the new h (a BOX that no longer holds
        the cell plan is re-planned by the first energy's overflow
        ladder, which reads the cell edges); the collection takes the new
        gids and group names, the state keeps its gids, group indices and
        masses (so GIDSHUFFLE and ASSIGNGROUPS reach only the files'
        names, as in the JAX package).  Otherwise (REPLICATE, APPEND,
        SELECTSUBSET, SHOCK, ALCHEMY, or a box that is no longer
        orthorhombic) a new State is built, with the JAX package's
        bookkeeping: masses and charges from the species (APPEND's own
        masses are not read), an unknown group name takes group 0, and
        the collection's class names are the old ones tiled and cut to
        the new count (after SELECTSUBSET the first n, not the kept
        ones); then the engine, the molecule class, the constraint
        projector, the plan, the force function and the step are
        derived anew (_derive), and the stale-list and overflow ladders
        start over.  On a deck with a MARTINI or CHARMM term the topology
        is built anew over the new collection first (core/system.
        build_topology: residues, bonded terms, exclusions, chain links,
        constraints; the JAX package keeps the old one, so only its first
        copy keeps its terms): a REPLICATE makes each molecule whole
        about its first bead before it tiles and wraps the copies into
        the new box after, and a transform that keeps part of a residue
        raises ValueError naming it.  The host steps (host_transform,
        same_particles, rebuild_system) are ParallelSimulation's too."""
        from ..core.box import Box

        sd = self.sysdef
        col = sd.collection
        n = sd.state.n_local
        st = self.ss.state

        def host(x):
            return x.detach().cpu().numpy().astype(np.float64)

        ctx, replicate = host_transform(
            sd, tobj, host(st.r[:n]), host(st.v[:n]), host(st.mass[:n]),
            host(self.ss.box.h),
            self.ss.box.pbc_mask.cpu().numpy().astype(np.float64),
            time=float(self.ss.time),
            rate=next((rate for _, t, rate in self.transforms if t is tobj),
                      1), run_dir=self.run_dir, base_dir=self.base_dir)
        box = Box.from_h(ctx.h, pbc=self.ss.box.pbc, dtype=self.dtype,
                         device=self.device)
        if same_particles(sd, ctx, box, self.ss.box.ortho):
            r = np.zeros((st.n_pad, 3))
            v = np.zeros((st.n_pad, 3))
            r[:n] = ctx.r
            v[:n] = ctx.v
            self.ss = self.ss.replace(
                state=st.replace(r=self._dev(r), v=self._dev(v)), box=box)
            col.gid = ctx.gid
            col.group_names = ctx.group_names
            self.first_energy()
            return
        rebuild_system(self.db, sd, tobj, ctx, box, replicate,
                       dtype=self.dtype, device=self.device)
        self.ss = self.ss.replace(state=sd.state, box=box)
        self._derive(box, self.ss.time)
        self._forced_spr = None
        self._forced_dispatch = None
        self._clean_disp = 0
        self.first_energy()

    def _dev(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _rescan_objects(self):
        """Re-derive live parameters from the re-compiled object DB, the
        reach of the reference's object_rescan (readCmds.c:66-97;
        simulate.py:1298-1367 of the JAX package): a command file can
        replace any object's text.

        * SIMULATE rates -> cfg fields;
        * GROUP targets (Teq schedules, Langevin tau, ...) -> the group
          table and the kick coefficients, which reach the step as
          tensors at every call; whether they refresh each dispatch is
          re-derived too (a CONSTANT Teq may have become a ramp);
        * INTEGRATOR parameters (barostat and thermostat targets) ->
          baked into the step: when they moved, the barostat and the
          step (and with it the force function and its bonded graph)
          are rebuilt;
        * TRANSFORM objects and rates -> the transform list;
        * each SIMULATE analysis's ANALYSIS eval_rate (or evalrate) and
          outputrate -> the analysis (simulate.py:1356-1363 of the JAX
          package; printStress's STRESSWRITE has no object and keeps
          printrate).  The analyses' objects and state stay: the rates
          are what a rescan reaches."""
        from ..core.groups import GroupTable, group_from_deck
        from ..core.system import integrator_parms_from_deck

        sd = self.sysdef
        cfg = sd.cfg
        sim = self.db.by_class("SIMULATE")[0]
        cfg.printrate = sim.get_int("printrate", cfg.printrate)
        cfg.checkpointrate = sim.get_int("checkpointrate", cfg.checkpointrate)
        cfg.snapshotrate = sim.get_int("snapshotrate", cfg.snapshotrate)
        cfg.maxloop = sim.get_int("maxloop", cfg.maxloop)
        sd.groups = [group_from_deck(self.db, g.name, i)
                     for i, g in enumerate(sd.groups)]
        sd.group_table = GroupTable.build(sd.groups)
        self._group_setup(self.ss.time)
        itype, iparms = integrator_parms_from_deck(self.db,
                                                   cfg.integrator_name)
        if itype == sd.integrator_type and iparms != sd.integrator_parms:
            sd.integrator_parms = iparms
            if self.barostat is not None and iparms["beta"] > 0:
                self.barostat = dict(
                    P0=iparms["P0"], beta=iparms["beta"],
                    tau=iparms["tauBarostat"], T=iparms["T"],
                    isotropic=iparms["isotropic"],
                    n_molecules=self.n_molecules)
            self._build_step()
        self.transforms = [
            (t, self.db.find(t, "TRANSFORM") or obj,
             (self.db.find(t, "TRANSFORM") or obj).get_int("rate", rate))
            for t, obj, rate in self.transforms]
        for a in self.analyses:
            obj = self.db.find(a.name, "ANALYSIS")
            if obj is not None:
                a.eval_rate = obj.get_int(
                    "eval_rate", obj.get_int("evalrate", a.eval_rate))
                a.output_rate = obj.get_int("outputrate", a.output_rate)

    def _rescan_guarded(self, raw: str):
        """Compile the command file's object text and rescan (the JAX
        package's simulate.py:1380-1393): when either fails, the run goes
        on as it was -- the deck's objects get back the keywords they had
        (and lose any the text added), and the Simulation, its sysdef and
        its SIMULATE config get back every attribute the rescan may have
        set, the analyses' rates among them -- with a warning."""
        sd = self.sysdef
        objects = dict(self.db.objects)
        keywords = {k: dict(o.keywords) for k, o in objects.items()}
        saved = [(x, dict(vars(x)))
                 for x in (self, sd, sd.cfg, *self.analyses)]
        try:
            self.db.compile_string(raw)
            self._rescan_objects()
        except Exception as err:
            self.db.objects = objects
            for k, o in objects.items():
                o.keywords = keywords[k]
            for x, attrs in saved:
                vars(x).update(attrs)
            warnings.warn("ddcMD_CMDS object rescan failed: "
                          f"{type(err).__name__}: {err}", stacklevel=3)

    def _poll_commands(self, on_checkpoint) -> bool:
        """The run-time command file (readCMDS, ddcMD src/readCmds.c:
        20-58): <run_dir>/ddcMD_CMDS, read and removed after every
        dispatch, may hold checkpoint / exit / kill / stop / profile /
        analysis / hpm (case-insensitive) and object text, which is
        compiled into the deck and rescanned.  Returns True when the run
        is to stop (exit = stop + checkpoint, readCmds.c:44)."""
        path = os.path.join(self.run_dir, "ddcMD_CMDS")
        try:
            with open(path) as f:
                raw = f.read()
        except FileNotFoundError:
            return False
        os.remove(path)
        text = raw.lower()           # object text keeps its case
        if "{" in raw:
            self._rescan_guarded(raw)
        if "checkpoint" in text and on_checkpoint:
            on_checkpoint(self)
        if "profile" in text:
            try:
                self.profile_phases()
            except Exception as err:
                print(f"profile: FAILED ({type(err).__name__}: {err})")
            print(PROFILE.table())
        if "analysis" in text:
            # DO_ANALYSIS (readCmds.c:47): every registered analysis now
            for a in self.analyses:
                a.eval(self)
                a.output(self, self.run_dir)
        if "hpm" in text:
            # HPM_PRINT: the reference stubs its hardware counters in this
            # release (hpmWrapper.c:20-23)
            print("hpm: no-op (reference stubs HPM in this release)")
        if "exit" in text and "checkpoint" not in text and on_checkpoint:
            on_checkpoint(self)
        return "kill" in text or "exit" in text or "stop" in text

    def profile_phases(self, n_iter: int = 10, detail: bool = False) -> dict:
        """Per-phase time attribution (the ptiming.h per-phase timers,
        ddcMD src/ptiming.h:10-36, profile.c:468; simulate.py:663-772 of
        the JAX package): the neighbor rebuild, the force evaluation,
        the group kick and the whole step, each called n_iter times on
        the current state and timed from before the first call to a
        device sync after the last (on the card: device time plus one
        launch-and-sync over n_iter); with detail=True also each force
        term and the constraint projection.  Results go into PROFILE as
        phase.* timers (n_iter calls each, so the table's avg is a
        call's) and are returned in seconds a call; phase.rtt is the
        launch and sync of one tiny kernel.  The run's state is not
        changed."""
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        ss, nbr, _ = self._build_nbr(self.ss)
        half = 0.5 * self.sysdef.cfg.dt
        noise, draws = self._noise(ss.loop)
        st = ss.state
        f = self.force_fn(st, ss.box, nbr)[0]
        phases = {
            "phase.nbr_rebuild": lambda: self._build_nbr(self.ss)[1],
            "phase.force": lambda: self.force_fn(st, ss.box, nbr)[0],
            "phase.group_kick": lambda: velocity_update(
                "front", st.v, f, st.mass, st.group, self.coeffs, half,
                noise[0], st.mask),
            "phase.step_fused": lambda: self.step_fn(
                ss, nbr, self.coeffs, noise[0], noise[1], draws=draws),
        }
        if detail:
            for term in self.force_fn.terms:
                name = term.__name__.replace("_term", "")
                phases[f"phase.term.{name}"] = (
                    lambda term=term: term(st, ss.box, nbr)[0])
            if self.constraint_fn is not None:
                phases["phase.constraint"] = lambda: self.constraint_fn(
                    st, self.sysdef.cfg.dt, "front",
                    box_lengths=ss.box.geom).v
        out, errors = {}, {}
        for name, fn in phases.items():
            try:
                fn()                      # warm-up (a graph's capture)
                sync()
            except Exception as err:      # a broken phase reports itself
                errors[name] = f"{type(err).__name__}: {err}"
                warnings.warn(f"profile_phases: {name} failed ({err!r}); "
                              "phase skipped", stacklevel=2)
                continue
            t0 = _time.perf_counter()
            for _ in range(n_iter):
                fn()
            sync()
            seconds = _time.perf_counter() - t0
            t = PROFILE.timer(name)
            t.total += seconds
            t.calls += n_iter
            out[name] = seconds / max(n_iter, 1)
        x = torch.zeros((8, 128), dtype=self.dtype, device=self.device)
        x + 1.0
        sync()
        t0 = _time.perf_counter()
        for _ in range(5):
            x + 1.0
            sync()
        out["phase.rtt"] = (_time.perf_counter() - t0) / 5
        if errors:
            out["errors"] = errors
        return out

    def run_nextfile(self, print_fn=None) -> StepState:
        """NEXTFILE integrator: 'integrate' by loading successive snapshot
        files (a replay; ddcMD src/nextfile.c:34-63; simulate.py:774-799
        of the JAX package).  Each file's positions and velocities are
        read in state order relative to the deck's directory, forces and
        energies evaluated once, and one line printed; the loop advances
        by one a file."""
        sd = self.sysdef
        iobj = self.db.get(sd.cfg.integrator_name, "INTEGRATOR")
        n_pad = sd.state.n_pad
        for i, fpat in enumerate(iobj.get_strv("files")):
            col = read_collection(fpat, self.base_dir)
            n = min(col.n, sd.state.n_local)
            r = np.zeros((n_pad, 3))
            v = np.zeros((n_pad, 3))
            r[:n] = col.r[:n]
            v[:n] = col.v[:n]
            self.ss = self.ss.replace(
                state=self.ss.state.replace(r=self._dev(r), v=self._dev(v)),
                loop=self.ss.loop + 1)
            self.first_energy()
            e = self.ss.energy
            (print_fn or print)(f"nextfile[{i}] {fpat}: eion="
                                f"{float(e.eion):.6f} rk={float(e.rk):.6f}")
        return self.ss

    def run_nglftest(self, print_fn=None) -> StepState:
        """NGLFTEST / NGLFERROR integrators (ddcMD src/nglfTest.c:63-110,
        nglfError.c; simulate.py:801-860 of the JAX package): integrate
        one dt three ways from the first energy -- one velocity-Verlet
        step ("single"), subDivide substeps ("multi") and a fine
        reference (highAccuarcyDt, (sic), default dt/32) -- each substep
        through the rebuild and forces of first_energy, and write the
        histograms of the per-particle position errors |r - r_ref|
        (minimum image) to SingleStep.dist and MultiStep.dist in the run
        directory; prints each one's median and maximum.  The run's
        state stays at the first energy."""
        sd = self.sysdef
        iobj = self.db.get(sd.cfg.integrator_name, "INTEGRATOR")
        dt = sd.cfg.dt
        sub = iobj.get_int("subDivide", 4)
        hi_dt = None
        for key in ("highAccuarcyDt", "highAccuracyDt"):
            if iobj.has(key):
                hi_dt = iobj.get_with_units(key, "0", "t")
        if not hi_dt:
            hi_dt = dt / 32.0
        n_hi = max(1, int(math.ceil(dt / hi_dt - 1e-9)))
        n = sd.state.n_local
        m = self.ss.state.mass[:, None]

        def substeps(ss, k, dtk):
            for _ in range(k):
                v1 = ss.state.v + 0.5 * dtk * ss.state.f / m
                r1 = ss.state.r + dtk * v1
                ss = self._energy_at(
                    ss.replace(state=ss.state.replace(r=r1, v=v1)))
                v2 = ss.state.v + 0.5 * dtk * ss.state.f / m
                ss = ss.replace(state=ss.state.replace(v=v2))
            return ss.state.r[:n].cpu().numpy().astype(np.float64)

        self.first_energy()
        ss0 = self.ss
        r_single = substeps(ss0, 1, dt)
        r_multi = substeps(ss0, sub, dt / sub)
        r_ref = substeps(ss0, n_hi, dt / n_hi)
        edges = np.logspace(-12, -2, 41)
        L = ss0.box.lengths.cpu().numpy().astype(np.float64)
        for name, rr in (("SingleStep.dist", r_single),
                         ("MultiStep.dist", r_multi)):
            # rebuilds wrap positions: two paths may differ by a box vector
            d = rr - r_ref
            d = d - L * np.round(d / L)
            err = np.linalg.norm(d, axis=1)
            hist, _ = np.histogram(err, bins=edges)
            with open(os.path.join(self.run_dir, name), "w") as f:
                f.write("# |r - r_ref| (nm)   count   "
                        f"(dt={dt} ps, sub={sub}, ref {n_hi} substeps)\n")
                for c, h in zip(np.sqrt(edges[:-1] * edges[1:]), hist):
                    f.write(f"{c:.6e} {int(h)}\n")
            (print_fn or print)(f"{name}: median={np.median(err):.3e} "
                                f"max={err.max():.3e} nm")
        return self.ss

    def _emit_prints(self, rows, k, print_fn):
        cfg = self.sysdef.cfg
        n_global = self.sysdef.state.n_local
        loop_end = self.ss.loop
        for j in range(k):
            loop = loop_end - k + 1 + j
            if not (cfg.printrate and loop % cfg.printrate == 0):
                continue
            eion, rk, tr_vir, tr_tion, vol = rows[j, :5]
            dof = 3.0 * n_global - self.sysdef.n_constraints
            temperature = 2.0 * rk / (dof * U.kB)
            if self.printinfo.print_molecular_pressure:
                # P = (tr_virial + 3 N_mol kB T) / 3V (molecularPressure.c),
                # with the atomic virial as the JAX package prints it
                pressure = ((tr_vir + 3.0 * self.n_molecules * U.kB
                             * temperature) / (3.0 * vol))
            else:
                pressure = (tr_vir + tr_tion) / (3.0 * vol)
            time_ps = self.ss.time - (k - 1 - j) * cfg.dt
            line = self.printinfo.row(loop, time_ps, eion, rk, temperature,
                                      pressure, vol, rows[j, 5:8], n_global)
            if print_fn:
                print_fn(line)
            else:
                self.printinfo.emit(line, self.run_dir)


def simulate_master(db: ObjectDB, base_dir: str = ".", run_dir: str = ".",
                    n_loops: int | None = None, device=None,
                    dtype=torch.float32) -> Simulation:
    """Run the deck on `device` (the CUDA card by default; raises without
    one) in `dtype` with checkpoints and snapshots at the deck's rates."""
    from ..io.restart import write_checkpoint

    sim = Simulation(db, base_dir, run_dir=run_dir, device=device,
                     dtype=dtype)
    sim.run(n_loops, on_checkpoint=lambda s: write_checkpoint(s, run_dir))
    return sim
