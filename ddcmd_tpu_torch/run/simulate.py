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
cell engines) asks for engine="nlist", and EAM with non-periodic axes
raises on the cell engines (item 27).  The cell-block plan is
CellBlockGrid.plan's and an overflow grows its cap by 1.5; the list's is
core/system.plan_grid's and an overflow grows its cell capacity and K
by 1.5.

One dispatch runs k steps as n_rebuilds blocks of `updateRate` steps:
each block rebuilds the cell slots or the list (the cell engines wrap
positions there; the list engine wraps after every drift, as the JAX
step does), then runs its steps on that handle.  Nothing in a dispatch
reads the device; the per-step scalars, the overflow flag and the worst
displacement are reduced on the device and copied to the host once at
the end of the dispatch (the JAX package's superchunk_fixed,
simulate.py:489-537).  The host then checks them:

  * overflow (a rebuild dropped particles or pairs, or a shrinking box
    took a cell edge below rlist -- `cell_edge_bad`): the dispatch is
    discarded and the grid replanned at the live box; if that changes
    nothing, the kernels' density safety grows by 1.3 first (the cell
    engines' and the list's room by 1.5).  Dynamic-box decks that keep
    overflowing halve the dispatch so the host replans along the
    compression;
  * non-finite energy: the kill switch raises (masters.c:470-475);
  * verlet-skin staleness (2 (max|dr| + 2 max|dh|) >= deltaR on a step
    that reused a list, dh the box motion since the rebuild): the
    dispatch is discarded and redone from the intact pre-dispatch state
    at halved rebuild cadence.  The thermostat noise is keyed by global
    step, so the redo replays the same noise.  Eight clean dispatches in
    a row double the cadence (and the dispatch) back; a stale redo
    restarts that count.

Dynamic boxes (a barostat's beta > 0, NPTGLF, NGLFNK, a box(t); the
JAX package's dyn_box) plan the grid with a 1.08 margin on rlist, so
compression does not trip the cell-edge guard right away, and count
their box motion in the staleness test.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
import warnings

import numpy as np
import torch

from ..core.energy import EnergyInfo
from ..core.groups import kick_noise, union_callsite
from ..core.molecule import build_molecule_class, make_molecular_virial_fn
from ..core.system import build_system, plan_grid
from ..integrators.nglf import StepState, first_energy_call, make_nglf_step
from ..integrators.nglfnk import make_nglfnk_step
from ..integrators.nptglf import make_nptglf_step
from ..nbr.celllist import build_neighbor_list, check_nonperiodic_cells
from ..objects import ObjectDB
from ..objects import units as U
from ..ops.cellpair import CellBlockGrid, build_cell_slots
from ..ops.cellpair_half import plan_lanes
from ..ops.eam_half import eam_half_supported
from ..potentials.pair import TABLE_ENGINE
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
# integrator types that run another master (ROADMAP item 23); every other
# type runs the NGLF step, as in the JAX package (simulate.py:264-355)
_MASTER_TYPES = ("NEXTFILE", "NGLFTEST", "NGLFERROR")
_NOISE_CALLSITE_NGLF = 0
# columns of the per-step row a dispatch returns
_ROW = ("eion", "rk", "tr_virial", "tr_tion", "volume", "Lx", "Ly", "Lz")


def uses_constraints(sd) -> bool:
    """True when the deck's integrator projects constraints (the
    NGLFCONSTRAINT family, RATTLE, NGLFNEW) and its topology has some."""
    uses = ("CONSTRAINT" in sd.integrator_type
            or "RATTLE" in sd.integrator_type
            or sd.integrator_type == "NGLFNEW")
    return uses and sd.bonded is not None and sd.bonded.n_constraints > 0


def refuse_unported_outputs(db: ObjectDB, sd, printinfo: PrintInfo):
    """Raise NotImplementedError for the outputs a deck asks for that the
    port does not write yet, instead of running to the end without them:
    SIMULATE analysis= / transform= lists and PRINTINFO printStress
    (which attaches STRESSWRITE) wait for ROADMAP item 24; printGraphs
    and the per-group energy files (written at printrate when the SYSTEM
    has more than one group) for item 23.  Both drivers call this when
    they are built (ddcmd_tpu/run/simulate.py:189-221,1105-1118)."""
    simobj = db.by_class("SIMULATE")[0]
    for key, cls in (("analysis", "ANALYSIS"), ("transform", "TRANSFORM")):
        names = [n for n in simobj.get_strv(key) if db.find(n, cls)]
        if names:
            raise NotImplementedError(
                f"SIMULATE {key}={' '.join(names)}: analyses and transforms "
                "are not ported yet (ROADMAP queue 1, item 24)")
    if printinfo.print_stress:
        raise NotImplementedError(
            "PRINTINFO printStress attaches the STRESSWRITE analysis, not "
            "ported yet (ROADMAP queue 1, item 24)")
    if printinfo.print_graphs:
        raise NotImplementedError(
            "PRINTINFO printGraphs: the graph files are not ported yet "
            "(ROADMAP queue 1, item 23)")
    if len(sd.groups) > 1 and sd.cfg.printrate:
        raise NotImplementedError(
            f"{len(sd.groups)} groups with printrate={sd.cfg.printrate}: the "
            "per-group energy files are not ported yet (ROADMAP queue 1, "
            "item 23)")


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
        self.run_dir = run_dir
        self.dtype = dtype
        self.sysdef = sd = build_system(db, base_dir, dtype=dtype,
                                        device=self.device)
        self.printinfo = PrintInfo.from_deck(db, sd.cfg.printinfo_name)
        refuse_unported_outputs(db, sd, self.printinfo)
        itype = sd.integrator_type
        if itype in _MASTER_TYPES:
            raise NotImplementedError(
                f"integrator {itype}: the NEXTFILE / NGLFTEST masters are "
                "not ported yet (ROADMAP queue 1, item 23)")
        self.engine = choose_engine(sd, dtype, engine)
        h = sd.box.h.cpu().numpy()
        if any(g.type in ("SHEAR", "SHWALL") for g in sd.groups) and \
                np.any(h[[2, 2, 0, 1], [0, 1, 2, 2]] != 0):
            # the shear slabs live in Cartesian z (shear.c), as in the
            # JAX package (simulate.py:108-117)
            raise NotImplementedError(
                "SHEAR/SHWALL need the c lattice vector along z (xy tilt "
                "is fine; z-coupled tilt is not)")
        ip = sd.integrator_parms
        sysobj = db.get(sd.cfg.system_name, "SYSTEM")
        self.molecules = build_molecule_class(
            db, sysobj, sd.collection.species_names, sd.collection.gid)
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
            self.molecules, dtype=dtype, device=self.device)
        self.constraint_fn = self._make_constraint_fn()
        self.post_drift_fn = None
        if any(p[0] == "REFLECT" for p in sd.potentials):
            from ..potentials.reflect import reflect

            self.post_drift_fn = reflect
        # dynamic boxes plan with shrink headroom (simulate.py:120-128)
        self._dyn_box = (sd.box_time is not None or itype in _NPT_TYPES
                         or ip["beta"] > 0)
        self._plan_margin = 1.08 if self._dyn_box else 1.0
        self._density_safety = 1.3
        self.grid = self._plan(sd.box)
        self._build_step()
        gt = sd.group_table
        self.coeffs = gt.coefficients(
            sd.cfg.time, 0.5 * sd.cfg.dt, dtype=dtype, device=self.device)
        # energy-feedback thermostat targets (Teq_dynamics=GLOBAL_ENERGY,
        # langevin.c:31-51): refreshed at every dispatch from the last
        # potential energy the host holds
        self._ge_groups = {g.index: g for g in gt.groups
                           if g.parms.get("teq_dynamics") == "GLOBAL_ENERGY"}
        self._ge_total: dict = {}
        self._eion_last = None
        self._refresh_coeffs = gt.time_dependent or bool(self._ge_groups)
        if itype in _NVE_TYPES:
            # NVE variants ignore thermostats: plain leapfrog kicks
            # (nveglf.c; simulate.py:331-337 of the JAX package)
            a, c_on, noise, vcm, kind, ber = self.coeffs
            self.coeffs = (torch.ones_like(a), torch.ones_like(c_on),
                           torch.zeros_like(noise), torch.zeros_like(vcm),
                           torch.zeros_like(kind), torch.zeros_like(ber))
            self._refresh_coeffs = False
        self._union_draws = gt.union_draws
        self._generator = torch.Generator(device=self.device)
        self._forced_spr = None
        self._forced_dispatch = None
        self._clean_disp = 0
        # counts of discarded dispatches, by cause
        self.redos = {"stale": 0, "overflow": 0}
        # (steps, seconds) of each accepted dispatch, host clock around
        # work that ends in the dispatch's one device sync
        self.dispatch_log: list[tuple[int, float]] = []
        # NPTGLF's zeta and NGLFNK's piston velocities start from the deck
        # (a restart file merges its values into the INTEGRATOR object)
        zeta0 = ip["zeta"] if itype == "NPTGLF" else 0.0
        bdot0 = np.zeros(3)
        if itype == "NGLFNK":
            bdot0 = db.get(sd.cfg.integrator_name, "INTEGRATOR") \
                .get_with_unitsv("bdot", "0 0 0", "l/t")
        self.ss = StepState(
            state=sd.state, box=sd.box,
            energy=EnergyInfo.zero(dtype=dtype, device=self.device),
            loop=sd.cfg.loop, time=sd.cfg.time,
            zeta=torch.tensor(zeta0, dtype=dtype, device=self.device),
            bdot=torch.as_tensor(np.asarray(bdot0, dtype=np.float64),
                                 dtype=dtype, device=self.device))

    # ------------------------------------------------------------------

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
        engine, plan_grid (perpendicular spans) for the list, which
        raises where a non-periodic axis has fewer than 3 cells (item
        28)."""
        sd = self.sysdef
        if self.engine == "nlist":
            grid = plan_grid(sd, plan_margin=self._plan_margin, box=box)
            check_nonperiodic_cells(grid.ncells, sd.box.pbc)
            return grid
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
            h_frac = None
            if not sd.box.ortho:
                h0 = sd.box.h.cpu().numpy().astype(np.float64)
                h_frac = h0 / np.linalg.norm(h0, axis=0)[None, :]
            self.step_fn = make_nglfnk_step(
                self.force_fn, sd.cfg.dt, T=ip["T"], tau=ip["tau"],
                Peq=ip["P"], W=ip["W"], kB=U.kB, wrap_positions=wrap,
                h_frac=h_frac)
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

    def first_energy(self) -> StepState:
        # a silent overflow would return energies from a dropped-pair
        # list: check the flag and replan like the run loop does
        for _ in range(10):
            ss, perm, ov = self._build_nbr(self.ss)
            if not bool(ov):
                self.ss = first_energy_call(ss, self.force_fn, perm)
                if self._ge_groups:
                    self._eion_last = float(self.ss.energy.eion)
                return self.ss
            self._replan_after_overflow()
        raise RuntimeError(
            "neighbor overflow persists in first_energy after repeated "
            "replans")

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

    def _noise(self, step: int):
        """The step's two kick draws (2, n_pad, 3) -- NGLFNK's g1 and g2
        -- and, with UNIONGROUPs, the member draws (2, members, n_pad, 3)
        at their own callsites, or None."""
        shape = (2, self.ss.state.n_pad, 3)
        seed = self.sysdef.random_seed
        noise = kick_noise(self._generator, seed, step, _NOISE_CALLSITE_NGLF,
                           shape, dtype=self.dtype)
        if not self._union_draws:
            return noise, None
        return noise, torch.stack([
            kick_noise(self._generator, seed, step, union_callsite(g, j),
                       shape, dtype=self.dtype)
            for g, j in self._union_draws], dim=1)

    def _ge_teq_override(self):
        """Live Teq of each GLOBAL_ENERGY Langevin group: the conserved
        bath + system energy is pinned at the first potential energy the
        host reads, then Teq = (total - E)/(Cp N) (langevin_getTemperature,
        src/langevin.c:31-51; simulate.py:249-263 of the JAX package).  E
        is the last step's energy from the previous dispatch's rows (or
        the first energy), so the refresh reads nothing from the device."""
        e = self._eion_last
        if not self._ge_groups or e is None or not np.isfinite(e):
            return None
        ng = self.sysdef.state.n_local
        out = {}
        for i, g in self._ge_groups.items():
            cp_n = g.parms["Cp"] * ng
            if i not in self._ge_total:
                self._ge_total[i] = float(g.Teq(0.0)) * cp_n + e
            out[i] = (self._ge_total[i] - e) / cp_n
        return out

    def _box_lam(self, n_steps: int):
        """The prescribed box(t) of the next n_steps steps as (E, M), each
        (n_steps, 3, 3) on the device: step i of the dispatch sets h =
        (E[i] * h0) @ M[i], h0 the dispatch's first box
        (boxPrescriptiveTime.c:96-145; simulate.py:1134-1170 of the JAX
        package, whose per-step factors are constant across a dispatch:
        E[i], M[i] are their i+1-th powers, taken in f64, so E[0], M[0]
        are the one-step factors).  STRAIN fills
        E elementwise, DEFORMATION_RATE fills M = expm(D dt), VOLUME a
        uniform E that reaches n Veq(t + S dt) at the dispatch's end.
        None without a box(t)."""
        bt = self.sysdef.box_time
        if bt is None:
            return None
        t = self.ss.time
        dt = self.sysdef.cfg.dt
        S = max(1, n_steps)
        steps = np.arange(1, S + 1, dtype=np.float64)[:, None, None]
        E = np.ones((S, 3, 3))
        M = np.broadcast_to(np.eye(3), (S, 3, 3)).copy()
        if bt["mode"] == "strain":
            log_e = np.array([[eq.integral(t, t + S * dt) / S for eq in row]
                              for row in bt["eqs"]])
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
            v_now = float(self.ss.box.volume)
            v_tgt = self.sysdef.state.n_local * float(bt["eq"](t + S * dt))
            E = E * np.exp(steps * math.log(v_tgt / v_now) / (3.0 * S))

        def dev(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        return dev(E), dev(M)

    def _dispatch(self, ss: StepState, n_rebuilds: int, spr: int,
                  box_lam=None):
        """n_rebuilds * spr steps with no host sync until the end
        (box_lam: the _box_lam of these steps, or None).  Returns (ss,
        rows (k, len(_ROW)) as numpy, overflow, worst displacement plus
        twice the box motion of a step whose list was reused)."""
        dev = self.device
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        worst = torch.zeros((), dtype=self.dtype, device=dev)
        rows = []
        h_start = ss.box.h
        for j in range(n_rebuilds):
            ss, perm, ov = self._build_nbr(ss)
            overflow = overflow | ov
            r0, h0 = ss.state.r, ss.box.h
            fmask = ss.state.fmask
            for i in range(spr):
                noise, draws = self._noise(ss.loop)
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
                rows.append(torch.stack([e.eion, e.rk, torch.trace(e.virial),
                                         torch.trace(e.tion), ss.box.volume,
                                         L[0], L[1], L[2]]))
        flags = torch.stack([overflow.to(self.dtype), worst])
        host = torch.cat([torch.stack(rows).reshape(-1), flags]).cpu()
        host = host.numpy().astype(np.float64)
        return (ss, host[:-2].reshape(-1, len(_ROW)), bool(host[-2]),
                float(host[-1]))

    def run(self, n_loops: int | None = None, *, print_fn=None,
            on_checkpoint=None,
            max_steps_per_dispatch: int = 400) -> StepState:
        """Run the MD loop; returns the final StepState.  With
        on_checkpoint (called with the Simulation) set, checkpoints are
        written at the deck's checkpointrate and snapshots (atoms + bxyz)
        at its snapshotrate, as the JAX package's run loop does."""
        sd = self.sysdef
        cfg = sd.cfg
        if n_loops is None:
            n_loops = (cfg.deltaloop if cfg.deltaloop
                       else cfg.maxloop - self.ss.loop)
        update_rate = max(1, cfg.ddc_update_rate)
        self.first_energy()
        done = 0
        ov_retries = 0
        while done < n_loops:
            k = min(n_loops - done, max_steps_per_dispatch,
                    self._forced_dispatch or n_loops)
            for rate in (cfg.checkpointrate, cfg.snapshotrate):
                if on_checkpoint and rate:
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
                self.coeffs = sd.group_table.coefficients(
                    self.ss.time, 0.5 * cfg.dt, dtype=self.dtype,
                    device=self.device, teq_override=self._ge_teq_override())
            t0 = _time.perf_counter()
            ss_new, rows, overflow, worst = self._dispatch(
                self.ss, n_rebuilds, spr, self._box_lam(k))
            seconds = _time.perf_counter() - t0
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
                raise FloatingPointError(
                    f"non-finite energy at loop "
                    f"{self.ss.loop + int(np.argmax(bad)) + 1} "
                    "(reference kill switch, masters.c:470-475)")
            if 2.0 * worst >= sd.neighbor_deltaR and spr > 1:
                warnings.warn(
                    f"neighbor list went stale (2*max_disp={2 * worst:.3f} "
                    f"nm >= deltaR={sd.neighbor_deltaR}); halving rebuild "
                    "cadence and redoing the dispatch", stacklevel=2)
                self.redos["stale"] += 1
                self._forced_spr = max(1, spr // 2)
                self._clean_disp = 0
                continue
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
            self._emit_prints(rows, k, print_fn)
            if on_checkpoint and cfg.checkpointrate \
                    and self.ss.loop % cfg.checkpointrate == 0:
                on_checkpoint(self)
            if on_checkpoint and cfg.snapshotrate \
                    and self.ss.loop % cfg.snapshotrate == 0:
                from ..io.restart import write_snapshot

                write_snapshot(self, self.run_dir)
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
