"""Deck-driven MD over a brick mesh, one rank per brick.

Counterpart of ddcmd_tpu/run/parallel_sim.py:ParallelSimulation:
`ddc DDC {lx=2; ly=2; lz=2;}` (the reference's domain lattice keywords,
ddc.c:35-137) or the `shape` argument selects the mesh, and each rank
runs one of two engines on its brick, picked as the JAX package picks
(_pick_shard_engine, its parallel_sim.py:647-683) at construction and
again at every replan and rebalance:

  * "pallas", parallel/brickstep_cells.BrickStepCells: the
    extended-grid kernels (TPU kernels #6 and #7), for a MARTINI deck
    whose exclusion components fit the in-kernel channels, a PAIR deck
    without a table (the MARTINI kernel with the species index as type
    and zero reaction-field constants), or EAM the kernels take (the
    analytic forms and the tabularFit=rational refit, 1-4 species), in
    f32, without Voronoi domains, every open axis's narrowest brick at
    least rlist (2 rlist on a 2-brick axis);
  * "nlist", parallel/brickstep.BrickStepList: the brick (N,K)-list
    engine in plain PyTorch for every other deck -- a PAIR
    TableFunction, an exclusion component wider than the channels
    (excluded partners masked in the list by gid), narrow bricks, EAM
    of any form and species count, f64 runs (`dtype=torch.float64`),
    VORONOI domains.
DDCMD_SHARD_ENGINE=pallas|nlist forces the engine; a forced pallas the
deck cannot take raises ValueError.

Covalent topologies ride along keyed by global id: the bonded terms in
`rf_add` mode (excluded pairs are masked in either engine, never
computed and subtracted), batched per residue type and, where they
cross residue instances (CHARMM junctions, CMAP), resolved per term; the
template-batched RATTLE groups (or the generic groups of a topology that
is not template-regular) and the multi-bead molecules of the molecular
virial, all resolved per rank (parallel/bonded_shard.py); migration is
molecule-coherent, the head bead of each chain deciding.  The
NGLFCONSTRAINT family with beta > 0 runs the Berendsen barostat in the
chunk, which carries the live box and the molecular virial diagonal;
the grids of every moving box keep a shrink margin, and the overflow
ladder replans against the live box.

Ranks come from torch.distributed (the caller initialises the process
group: NCCL for CUDA tensors, one card per rank; gloo for the CPU).  A
(1, 1, 1) mesh needs no process group.  Every rank builds the system
from the deck, keeps the rows of its own brick, and runs the same host
loop; the per-step scalars and the overflow flag are mesh-wide, so all
ranks take the same decisions.

The nonbond term is the deck's one MARTINI, EAM or PAIR potential,
selected by type as the JAX mesh selects it (parallel_sim.py:58-90);
NONE terms carry no force and are dropped.  Where the JAX mesh would
drop a force silently, the port raises naming item 25: RESTRAINT and
REFLECT, PAIRENERGY and ORDERSH (the JAX mesh ignores all four), a
second nonbond term and a deck with no nonbond term.

Load balance: `loadBalance=lb` on the DDC object names a LOADBALANCE
object (loadBalance.c:32-85) of type ZRAMP or TENSOR (per-axis
equal-work walls, loadbalance.tensor_walls with workPower), BISECTION
(ORCB walls, loadbalance.orcb_walls) or VORONOI (nearest-centre domains
moved by voronoi.balance_step with its eta), computed from the start
positions and recomputed at `rate` inside run (rebalance), the JAX
package's parallel_sim.py:117-160 and :926-1009.  A restart whose
snapshot holds a pxyz of the same mesh shape and balancer family
resumes its walls or centres (DDCMD_PXYZ_RESTART=0 turns this off).
write_checkpoint writes one atoms# shard per rank plus the restart and
the pxyz (the reference's N-writer pio layout); view() gathers r, v and
f by gid into a Simulation-shaped view; run_analyses() evaluates the
deck's ANALYSIS objects, five of them sharded (analysis/registry.py
eval_sharded).  On an axis of three or more bricks every brick must be
at least rlist wide (the staged halo reaches one brick): ValueError.

Triclinic boxes (BOX type=GENERAL) run as the JAX mesh runs them
(parallel_sim.py:1-17, 96-107, 926-937 there): on the list engine, with
ownership, walls, halos and migration in the fraction s = h^-1 r and
perpendicular-span windows (parallel/brick.py), the Berendsen move
h' = diag(lam) h, and the load balance in the frame r h^-T L (L the
perpendicular spans), where VORONOI domains are Euclidean; `Lv` carries
the (3, 3) h, the checkpoint and the view a GENERAL box.

Outputs at their rates, as Simulation writes them: SIMULATE analysis=
and printStress's STRESSWRITE (built once, their accumulators kept
across evaluations), the graphs file (printGraphs, one line a dispatch
with the owned count of each brick) and the per-group energy files
(more than one group, at printrate, each group's count and energies
summed over the mesh in one all-reduce).  Every dispatch ends on each
analysis's eval_rate and outputrate multiple and, with group files, on
each printrate multiple.  At an eval the five classes with eval_sharded
sum owned-row partials over the mesh; the others evaluate on rank 0
over view(), which carries the last step's per-row forces and potential
energies and its mesh-wide virial and kinetic tensors; rank 0 writes.
The JAX mesh writes none of these (its parallel_sim.py:452-472).
run(migrate_rate=) takes the JAX package's migration cadence: the
chunk length under a moving box, per-step dispatches with a migration
on each loop migrate_rate divides under NVT, both under a drift guard
(parallel/brickstep.BrickStepBase) that flags a row moved half the skin
since its last migration, so the host redistributes instead of losing
its pairs.

Dynamics as Simulation runs them (ROADMAP item 22; integrators/nglf.py,
nptglf.py, nglfnk.py and core/groups.py, whose pieces both drivers
call): the NGLF family with the Berendsen barostat and RATTLE (NGLFNEW
with constraints too, as Simulation's uses_constraints has it), the
NVEGLF variants on plain leapfrog coefficients, NPTGLF (zeta from the
last step's mesh-wide pressure, the five-pass rescale on the mesh-wide
kinetic tensor) and NGLFNK (per-axis pistons, Pxx and Pyy averaged, the
fixed-shape triclinic piston), a prescribed box(t) (STRAIN, VOLUME at
the mesh-wide volume, DEFORMATION_RATE; a tilting rate takes the list
engine from the start, as any triclinic box), EXTFORCE forces, the hook
groups (the SHEAR and SHWALL slice statistics summed over the ranks,
DOUBLE_MIRROR per row, UNIONGROUP member draws at their own callsites
on each rank's rows), and the group coefficients refreshed once a
dispatch at its start time (Teq and PISTON vz schedules, GLOBAL_ENERGY
targets from the mesh-wide energy of the last row).  One chunk carries
the box and barostat state (BrickStepBase.chunk: the live box, the
molecular virial diagonal, zeta, bdot, the last pressure tensor), and a
flagged chunk rolls back whole and replans.  The JAX mesh runs every one
of these decks as plain NGLF with constant coefficients (ROADMAP
queue 3); the port does not copy that.

SIMULATE transform= at its rates, as Simulation applies it (the JAX mesh
reads no transform= and applies none): every dispatch ends on each
transform's rate, and after the outputs each due transform runs through
apply_transform -- r and v gathered by gid, the transform on rank 0's
host, its result broadcast; the same particles re-uploaded at the new
box, or the system rebuilt (state, topology, load balance, plan,
engine and step: _derive, which construction runs too).  The rows keep
their own key, the state's gid, while a GIDSHUFFLE renames the
collection's gids, which the checkpoint writes.

Deck features outside these paths raise NotImplementedError naming
their ROADMAP item: non-periodic axes (item 25: the JAX mesh reads no
pbc bit and would run such a deck fully periodic) and the NEXTFILE and
NGLFTEST masters, as do a SHEAR group in a box whose c vector is tilted
(as Simulation).
"""

from __future__ import annotations

import os
import time as _time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..core.box import geom_volume
from ..core.energy import kinetic_terms
from ..core.molecule import build_molecule_class
from ..core.system import build_system
from ..objects import ObjectDB
from ..objects import units as U
from ..nbr.celllist import CellGrid
from ..ops.cellpair import perp_spans as host_spans
from ..ops.eam_half import eam_half_supported
from ..parallel.bonded_shard import (constraint_gid_tables,
                                     mesh_bonded_plan, molecule_gid_tables)
from ..parallel.brick import (BrickPlan, check_orcb_reach,
                              distribute_bricks, gid64)
from ..parallel.brickstep import (SCALAR_COLS, BrickStepList,
                                  exclusion_gids)
from ..parallel.brickstep_cells import BrickStepCells
from ..parallel.mesh import BrickMesh
from ..parallel.shard_cells import plan_shard_cells, walls_span_minmax
from ..potentials.eam import eam_device_tables
from ..potentials.martini import martini_device_tables
from ..potentials.pair import pair_device_tables
from .forces import (_excl_channels, bonded_tables,
                     wide_exclusion_component)
from .printinfo import PrintInfo
from .simulate import (_BAROSTAT_TYPES, _MASTER_TYPES, box_time_factors,
                       deck_analyses, deck_transforms, dynamic_box,
                       global_energy_groups, global_energy_teq,
                       host_transform, live_coefficients, nglfnk_h_frac,
                       piston_start, rebuild_system, refreshes_coefficients,
                       refuse_shear_tilt, same_particles, uses_constraints,
                       write_graphs_line, write_group_row)

_MESH_ITEM = "ROADMAP queue 1, item 25"
# NPT decks plan cells with shrink headroom (the JAX package's
# plan_shard_cells margin for NPT decks, and its list grid's)
_NPT_PLAN_MARGIN = 1.08
_NPT_LIST_MARGIN = 1.1


def _cap(x: int) -> int:
    return ((int(x) + 7) // 8) * 8


def lb_frame(geom, r=None):
    """(L, r_lb) of the box geom ((3,) lengths or a (3, 3) h): the
    per-axis perpendicular spans and the positions r in the load-balance
    frame, the fraction scaled by the spans (r itself when orthorhombic;
    None without r), the JAX package's _lb_frame (parallel_sim.py:
    926-937)."""
    geom = np.asarray(geom, np.float64)
    if geom.ndim == 1:
        return geom, r
    L = host_spans(geom)[0]
    if r is None:
        return L, None
    return L, np.asarray(r) @ np.linalg.inv(geom).T * L[None, :]


def live_h(geom) -> np.ndarray:
    """The (3, 3) h of a box geometry ((3,) lengths or h)."""
    geom = np.asarray(geom, np.float64)
    return np.diag(geom) if geom.ndim == 1 else geom


def _mesh_device(device):
    """`device` when given, else this rank's CUDA card (cuda:LOCAL_RANK
    under a launcher, cuda:0 alone); raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run the '
                           "mesh on the CPU (gloo ranks)")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device(f"cuda:{local}")


def chain_head_gids(gid, residue_instances, chain_links) -> np.ndarray:
    """(n,) int64: the gid of each particle's molecule head, the first atom
    of its CHAIN (a maximal run of residue instances joined by junction
    terms; `chain_links` lists each instance i joined to instance i + 1).
    A residue-level head would split a chain across ranks."""
    gid = np.asarray(gid, np.int64)
    hgid = gid.copy()
    linked = set(np.asarray(chain_links).tolist()) \
        if chain_links is not None else set()
    head_rows = None
    for i, (_name, rows) in enumerate(residue_instances or []):
        if head_rows is None or (i - 1) not in linked:
            head_rows = rows
        hgid[np.asarray(rows)] = gid[head_rows[0]]
    return hgid


def _portable(err: Exception) -> Exception:
    """err when it pickles (a broadcast carries it to every rank), else a
    RuntimeError naming it."""
    import pickle

    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:
        return RuntimeError(f"{type(err).__name__}: {err}")


class ParallelSimulation:
    """Sharded run of a MARTINI (water box, bilayer, CHARMM), PAIR or EAM
    deck over a brick mesh under any of Simulation's integrators (the
    NGLF family with the Berendsen barostat, the NVE variants, NPTGLF,
    NGLFNK), box(t) and GROUP types, in f32 or f64, with SIMULATE's
    analyses and transforms at their rates (run, apply_transform)."""

    def __init__(self, db: ObjectDB, base_dir: str = ".", *, shape=None,
                 device=None, dtype=torch.float32, run_dir: str = "."):
        self.device = dev = _mesh_device(device)
        self.run_dir = run_dir
        self.base_dir = base_dir
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype}: the mesh runs float32 or "
                             "float64")
        self.dtype = dtype
        sd = build_system(db, base_dir, dtype=dtype, device="cpu")
        self.sysdef = sd
        self.printinfo = PrintInfo.from_deck(db, sd.cfg.printinfo_name)
        if sd.integrator_type in _MASTER_TYPES:
            # Simulation runs them; the JAX mesh has no such path
            raise NotImplementedError(
                f"integrator {sd.integrator_type}: the NEXTFILE / NGLFTEST "
                f"masters do not run under the mesh yet ({_MESH_ITEM})")
        refuse_shear_tilt(sd)
        if sd.box.pbc & 7 != 7:
            raise NotImplementedError(
                f"pbc={sd.box.pbc} under the mesh: the JAX mesh reads no pbc "
                "bit and would run the deck fully periodic; non-periodic "
                f"bricks are not ported yet ({_MESH_ITEM})")

        self.db = db
        sim = db.by_class("SIMULATE")[0]
        ddc = db.find(sim.get_str("ddc", "ddc"), "DDC")
        if shape is None and ddc is not None and ddc.has("lx"):
            shape = (ddc.get_int("lx", 1), ddc.get_int("ly", 1),
                     ddc.get_int("lz", 1))
        if shape is None:
            shape = ((dist.get_world_size() if dist.is_initialized() else 1),
                     1, 1)
        self.shape = tuple(int(s) for s in shape)
        self.mesh = BrickMesh(self.shape, dev)

        ptype, parms = self._nonbond_term(sd)
        # the list engine's tables in the run's dtype; the cells engine's
        # (f32, the MARTINI types collapsed when one is used) by
        # _cell_tables
        if ptype == "MARTINI":
            tables = martini_device_tables(parms, dtype=dtype, device=dev)
            tmap = np.asarray(parms.species_lj_type)
            self.force_kind = "martini"
        elif ptype == "PAIR":
            # without a table: the MARTINI path with zero reaction-field
            # constants, the species index as type (parallel_sim.py:74-92
            # of the JAX package); a TableFunction takes pair_lj
            tables = pair_device_tables(parms, dtype=dtype, device=dev)
            tmap = np.arange(len(sd.species))
            self.force_kind = "pairtab" if parms.table is not None \
                else "martini"
        else:
            tables = eam_device_tables(parms, dtype=dtype, device=dev)
            tmap = np.arange(len(sd.species))
            self.force_kind = "eam"
        self._ptype = ptype
        self.tables, self._tmap = tables, tmap
        self.chunk_steps = max(1, int(sd.cfg.ddc_update_rate))
        self.loop = sd.cfg.loop
        self._density_safety = 1.3
        self._grid_growth = 1.0
        self._eion_last = None
        # the box and barostat state a step carries (box_state): the live
        # box (_derive), the last molecular virial diagonal the next
        # Berendsen lambda reads, NPTGLF's zeta, NGLFNK's piston
        # velocities and the last step's mesh-wide virial plus kinetic
        # tensor (their pressure); a transform keeps zeta and bdot, as
        # Simulation's does
        zeta0, bdot0 = piston_start(db, sd)
        self.vird = torch.zeros(3, dtype=dtype, device=dev)
        self.zeta = torch.tensor(zeta0, dtype=dtype, device=dev)
        self.bdot = torch.as_tensor(bdot0, dtype=dtype, device=dev)
        self.ptens = torch.zeros((3, 3), dtype=dtype, device=dev)
        # the load balance at the start positions (or a restart's pxyz)
        _, L, r_lb = self._system_frame()
        self._derive(*self._setup_loadbalance(db, ddc, base_dir, L,
                                              self._rlist(), r_lb))
        self.f = None
        # (steps, seconds) of each accepted dispatch, host clock around
        # work that ends in the dispatch's one device-to-host read
        self.dispatch_log: list[tuple[int, float]] = []
        self.n_rebalance = 0
        self.analyses = deck_analyses(db, sd, self.printinfo)
        # SIMULATE transform=, applied after the analyses at the dispatch
        # ends their rates divide (apply_transform)
        self.transforms = deck_transforms(db)
        # the last accepted step's scalar row (virial and kinetic tensors
        # for the view), and whether every row sits in its brick (the
        # last dispatch ended in a migration or a distribution)
        self._last_row = None
        self.rows_home = True

    def _rlist(self) -> float:
        sd = self.sysdef
        return sd.rcut_max + sd.neighbor_deltaR

    def _system_frame(self):
        """(geom, L, r_lb) of the system's box (the deck's, or a
        rebuilding transform's) and positions: geom as the step takes it
        ((3,) lengths, or the (3, 3) h when triclinic), L the per-axis
        perpendicular spans every plan measures rlist against, r_lb the
        positions in the load-balance frame, the fraction scaled by L
        (JAX parallel_sim.py:96-107); f64 on the host."""
        sd = self.sysdef
        box = sd.box
        geom = np.asarray((box.lengths if box.ortho else box.h).numpy(),
                          dtype=np.float64)
        L = np.asarray(box.perp_spans.numpy(), dtype=np.float64)
        r_lb = sd.state.r[:sd.state.n_local].numpy()
        if not box.ortho:
            r_lb = r_lb @ np.linalg.inv(geom).T * L[None, :]
        return geom, L, r_lb

    def _derive(self, walls=None, voronoi=None):
        """What the run derives from its particles and box (Simulation's
        _derive): the box kind and geometry (`_tri`, the live box `Lv`,
        (3,) lengths or the (3, 3) h), the brick plan at the spans with
        `walls` or `voronoi` (the load balance from the positions when
        both are None), the Coulomb flag, the group coefficients and
        their refresh, the barostat, the topology's gid tables and the
        step's dynamics, the engine and its step, the host arrays and
        their distribution.  Run at construction and after a transform
        changed the particle count, the species or the box kind."""
        sd = self.sysdef
        n = sd.state.n_local
        self._tri = not sd.box.ortho
        geom, L, r_lb = self._system_frame()
        if walls is None and voronoi is None and self._lb_kind is not None:
            if self._lb_kind == "voronoi":
                from ..parallel.voronoi import nominal_centers

                voronoi = dict(centers=nominal_centers(L, self.shape),
                               margins=np.zeros(3), L0=L.copy())
            else:
                walls = self._lb_walls(r_lb, L, self._rlist())
        self.plan = self._brick_plan(L, walls, voronoi)
        self._check_reach(L)
        self._coulomb = bool(np.any(sd.state.q[:n].numpy() != 0.0))
        # the group coefficients, refreshed once a dispatch at its start
        # time when a schedule or a GLOBAL_ENERGY target moves them
        # (Simulation's rule); the energy the targets read pins their
        # totals anew at the next refresh
        self._ge_groups, self._ge_total = global_energy_groups(sd), {}
        self._refresh_coeffs = refreshes_coefficients(sd)
        self.coeffs = live_coefficients(sd, self._time(), self.dtype,
                                        self.device)
        self._dyn_box = dynamic_box(sd)
        # the rows' own key: the state's gids, which a transform's fast
        # path keeps while the collection takes its new gids (GIDSHUFFLE)
        # for the files
        self._gid = gid = gid64(sd.state.gid[:n])
        self._setup_barostat(gid)
        self._setup_topology(gid)
        self._dynamics = self._dynamics_spec()
        self.Lv = torch.as_tensor(geom, dtype=self.dtype, device=self.device)
        self._host_arrays = dict(
            r=sd.state.r[:n].numpy(), v=sd.state.v[:n].numpy(),
            q=sd.state.q[:n].numpy(), mass=sd.state.mass[:n].numpy(),
            species=sd.state.species[:n].numpy(),
            group=sd.state.group[:n].numpy(), gid=gid)
        if self._hgid is not None:
            self._host_arrays["hgid"] = self._hgid
        self.fields = None
        self._build_step_fns()
        self._distribute(self._host_arrays)

    def _brick_plan(self, L, walls, voronoi) -> BrickPlan:
        """The BrickPlan of the current particle count at spans L: local,
        halo and migration capacities from n, the bricks and the halo
        windows."""
        n = self.sysdef.state.n_local
        n_dev = self.mesh.size
        rlist = self._rlist()
        # halo windows scale with rlist / brick width (parallel_sim.py:
        # 182-202 of the JAX package); Voronoi windows widen by the
        # bisector margin, reserved for the centres' displacement bound
        per_dev = max(1, n // n_dev)
        width = min(L[a] / self.shape[a] for a in range(3))
        win = rlist
        if voronoi is not None:
            from ..parallel.voronoi import beta_max

            win = rlist + 0.75 * beta_max(L, self.shape) * width
        frac = min(1.0, win / width)
        halo_est = int(per_dev * (1 + 2 * frac) ** 2 * frac * 1.8) + 64
        halo = max(3 * n // n_dev // 2, halo_est)
        if self._lb_kind == "bisection":
            # under ORCB an earlier phase's ghosts are forwarded from
            # across a neighbour's whole range (parallel/brick.py): half
            # as much room again
            halo = 3 * halo // 2
        return BrickPlan(
            shape=self.shape,
            local_cap=_cap(n) if n_dev == 1 else _cap(4 * n // n_dev),
            halo_cap=_cap(halo),
            migrate_cap=_cap(max(256, n // (4 * n_dev))), rlist=rlist,
            walls=walls, voronoi=voronoi)

    # ------------------------------------------------------------------

    def _setup_loadbalance(self, db, ddc, base_dir, L, rlist, r_lb):
        """The deck's LOADBALANCE (JAX parallel_sim.py:117-180), at the
        spans L from the positions r_lb of the load-balance frame: ZRAMP and
        TENSOR take per-axis equal-work walls (workPower, default 2),
        clamped to 1.05 rlist; BISECTION the ORCB walls; VORONOI
        nearest-centre domains, the centres starting at the brick
        centres and moved by balance_step (its `eta`, default 0.5); each
        with its `rate`.  A restart's pxyz of the same mesh shape and
        family supplies the walls or centres instead
        (DDCMD_PXYZ_RESTART=0: never).  Returns (walls, voronoi), None
        for what the plan does not use."""
        self.lb_rate, self._lb_kind, self._lb_work_power = 0, None, 2
        self._lb_eta = 0.5
        name = ddc.get_str("loadBalance", "") if ddc is not None else ""
        if not name:
            return None, None
        lbobj = db.find(name, "LOADBALANCE")
        if lbobj is None:
            raise ValueError(f"DDC loadBalance={name}: no LOADBALANCE "
                             "object of that name")
        kind = lbobj.get_str("type", "").upper()
        if kind not in ("ZRAMP", "TENSOR", "BISECTION", "VORONOI"):
            raise NotImplementedError(
                f"LOADBALANCE type={kind or '(none)'}: the mesh balances "
                "ZRAMP, TENSOR and BISECTION walls and VORONOI domains")
        self._lb_kind = {"BISECTION": "bisection",
                         "VORONOI": "voronoi"}.get(kind, "tensor")
        self._lb_work_power = lbobj.get_int("workPower", 2)
        self._lb_eta = lbobj.get_float("eta", 0.5)
        self.lb_rate = lbobj.get_int("rate", 0)
        walls = voronoi = None
        if self._lb_kind == "voronoi":
            from ..parallel.voronoi import nominal_centers

            voronoi = dict(centers=nominal_centers(L, self.shape),
                           margins=np.zeros(3), L0=L.copy())
        else:
            walls = self._lb_walls(r_lb, L, rlist)
        if os.environ.get("DDCMD_PXYZ_RESTART", "1") != "0":
            from ..io.pxyz import restore_plan_lb

            colobjs = db.by_class("COLLECTION")
            files_v = colobjs[0].get_str("files", "") if colobjs else ""
            w_saved, v_saved = restore_plan_lb(
                os.path.join(base_dir, os.path.dirname(files_v), "pxyz"),
                self.shape, self._lb_kind)
            if w_saved is not None:
                walls = tuple(tuple(w) if np.asarray(w).ndim == 1
                              else np.asarray(w) for w in w_saved)
            if v_saved is not None:
                voronoi = v_saved
        return walls, voronoi

    def _lb_walls(self, r, L, rlist):
        """Walls of this run's balancer from positions r of the
        load-balance frame at spans L (the JAX package's __init__ and
        parallel_rebalance branches); ORCB walls are checked against the
        staged exchange's reach."""
        if self._lb_kind == "bisection":
            from ..parallel.loadbalance import orcb_walls

            walls = orcb_walls(r, L, self.shape, min_frac=tuple(
                1.05 * rlist / L[a] for a in range(3)))
            check_orcb_reach(walls, self.shape, rlist / L)
            return walls
        from ..parallel.loadbalance import clamp_walls, tensor_walls

        raw = tensor_walls(r, L, self.shape, work_power=self._lb_work_power)
        return tuple(tuple(clamp_walls(w, 1.05 * rlist / L[a]))
                     for a, w in enumerate(raw))

    def _dynamics_spec(self) -> dict:
        """BrickStepBase's keywords of the deck's integrator and groups:
        the step kind (NGLF family, NPTGLF, NGLFNK), NPTGLF's constants or
        NGLFNK's PistonNK (with the fixed-shape h_frac of a triclinic
        start box, as Simulation), the hook groups and the UNIONGROUP
        member draws (NGLF family only, as Simulation's steps read them),
        the EXTFORCE forces by group, and the run's clock (_time)."""
        sd = self.sysdef
        ip = sd.integrator_parms
        gt = sd.group_table
        kind = {"NPTGLF": "nptglf",
                "NGLFNK": "nglfnk"}.get(sd.integrator_type, "nglf")
        ext = np.array([g.extforce for g in sd.groups], dtype=np.float64)
        spec = dict(kind=kind, clock=self._time,
                    extforce=ext if np.any(ext != 0.0) else None)
        if kind == "nglf":
            spec.update(hooks=gt.shear_groups, union_draws=gt.union_draws)
        elif kind == "nptglf":
            spec["nptglf"] = dict(n_global=sd.state.n_local,
                                  Gamma=ip["Gamma"], Peq=ip["pressure"])
        else:
            from ..integrators.nglfnk import PistonNK

            spec["piston"] = PistonNK(sd.cfg.dt, T=ip["T"], tau=ip["tau"],
                                      Peq=ip["P"], W=ip["W"], kB=U.kB,
                                      h_frac=nglfnk_h_frac(sd))
        return spec

    @staticmethod
    def _nonbond_term(sd):
        """(type, parms) of the deck's one nonbond term (MARTINI, EAM or
        PAIR), NONE terms dropped; any other term, a second nonbond term
        or none at all raises naming item 25."""
        nonbond, other = [], []
        for ptype, name, parms in sd.potentials:
            if ptype in ("MARTINI", "EAM", "PAIR"):
                nonbond.append((ptype, parms))
            elif ptype != "NONE":
                other.append(f"{ptype} ({name})")
        if other:
            raise NotImplementedError(
                f"{', '.join(other)} under the mesh: the JAX mesh drops such "
                "terms silently (parallel_sim.py:58-90); they are not ported "
                f"to the mesh yet ({_MESH_ITEM})")
        if len(nonbond) != 1:
            raise NotImplementedError(
                f"{len(nonbond)} nonbond terms (MARTINI, EAM or PAIR) under "
                "the mesh: it runs exactly one (the JAX mesh keeps the "
                f"first it finds and drops the rest) ({_MESH_ITEM})")
        return nonbond[0]

    def _setup_barostat(self, gid):
        """The Berendsen barostat of the NGLFCONSTRAINT family (beta > 0)
        and, for multi-bead molecules, the gid-keyed molecule table of
        the sharded molecular virial (JAX parallel_sim.py:266-295)."""
        sd = self.sysdef
        ip = sd.integrator_parms
        self.barostat, self._mol_gids = None, None
        self.n_molecules = sd.state.n_local
        if sd.integrator_type not in _BAROSTAT_TYPES or not ip["beta"] > 0:
            return
        sysobj = self.db.get(sd.cfg.system_name, "SYSTEM")
        mols = build_molecule_class(self.db, sysobj,
                                    sd.collection.species_names,
                                    sd.collection.gid)
        if mols:
            self.n_molecules = mols.n_molecules
            if mols.n_molecules < sd.state.n_local:
                tab = molecule_gid_tables(mols, gid)
                self._mol_gids = None if tab is None else tab["mol_gids"]
        self.barostat = dict(P0=ip["P0"], beta=ip["beta"],
                             tau=ip["tauBarostat"], T=ip["T"],
                             isotropic=ip["isotropic"],
                             n_molecules=self.n_molecules)

    def _setup_topology(self, gid):
        """Gid-keyed covalent tables (JAX parallel_sim.py:226-401): the
        bonded terms in rf_add mode (batched per residue type, the rest
        per term), the exclusions as the cells engine's in-kernel
        channels (when every component fits them) and as the list
        engine's partner gids, the RATTLE templates (or generic groups),
        and the chain-head gids of molecule-coherent migration."""
        sd = self.sysdef
        bt = sd.bonded
        self._bonded_plan = self._bonded_left = None
        self._cons_templates = self._cons_tables = None
        self._hgid = self._excl_vals = self._exgid = None
        self._wide = 0
        if bt is None:
            return
        from ..integrators.constraints import build_constraint_templates

        n = sd.state.n_local
        if bt.exclusions is not None and len(bt.exclusions) \
                and self.force_kind == "martini":
            self._wide = wide_exclusion_component(sd)
            if not self._wide:
                self._excl_vals = _excl_channels(bt.exclusions, n)
            self._exgid = exclusion_gids(bt.exclusions, gid, n)
        btab = bonded_tables(sd, self.dtype)
        if btab is not None:
            self._bonded_plan, self._bonded_left = mesh_bonded_plan(
                btab, sd.residue_instances, n, gid, self.device, self.dtype)
        if uses_constraints(sd):
            self._cons_templates = build_constraint_templates(
                bt.cons_atoms, bt.cons_pairs, bt.cons_dist,
                sd.residue_instances, gid)
            if self._cons_templates is None:
                self._cons_tables = constraint_gid_tables(bt, gid)
        self._hgid = chain_head_gids(gid, sd.residue_instances,
                                     bt.chain_links)

    def _check_reach(self, L):
        """On an axis of three or more bricks the staged exchange reaches
        one brick, so every brick there must be at least rlist wide at
        box L, on either engine (an axis of one or two bricks takes any
        width: min-image covers it).  Raises ValueError."""
        sf_min, _ = walls_span_minmax(self.plan.walls, self.shape)
        for a in range(3):
            span = L[a] * sf_min[a]
            if self.shape[a] > 2 and span < self.plan.rlist:
                raise ValueError(
                    f"axis {a}: brick {span:.4f} < rlist "
                    f"{self.plan.rlist:.4f} with {self.shape[a]} bricks: "
                    "the staged halo exchange reaches one brick; use fewer "
                    "bricks along that axis")

    def _pick_shard_engine(self, L) -> str:
        """"pallas" (the cells engine, TPU kernels #6 and #7) or "nlist"
        (the brick list engine), the JAX package's _pick_shard_engine
        (parallel_sim.py:647-683): the cells engine takes an orthorhombic
        MARTINI deck (its exclusion components within the in-kernel
        channels), PAIR deck without a table, or EAM deck the kernels
        take, in f32, without Voronoi domains, with every open axis's
        narrowest brick at least rlist (2 rlist on a 2-brick axis), at
        the spans L; every other deck, a triclinic one too, takes the
        list engine.  DDCMD_SHARD_ENGINE=pallas|nlist forces the engine;
        a forced pallas the deck or geometry cannot take raises
        ValueError."""
        why = None
        if self._tri:
            why = "a triclinic box"
        elif self.force_kind == "pairtab":
            why = "a PAIR TableFunction"
        elif self.force_kind == "eam" and not eam_half_supported(self.tables):
            why = (f"EAM form {self.tables['form']} with "
                   f"{self.tables['n_species']} species (the EAM kernels "
                   "take the analytic forms and the tabularFit=rational "
                   "refit with 1-4 species)")
        elif self.dtype != torch.float32:
            why = f"dtype {self.dtype}"
        elif self.plan.voronoi is not None:
            why = "VORONOI domains"
        elif self._wide:
            why = (f"an exclusion component of {self._wide} particles "
                   "(wider than the in-kernel channels encode)")
        else:
            sf_min, _ = walls_span_minmax(self.plan.walls, self.shape)
            for a in range(3):
                na, span = self.shape[a], L[a] * sf_min[a]
                if na > 1 and span < self.plan.rlist * (2.0 if na == 2
                                                        else 1.0):
                    why = (f"axis {a}: brick {span:.3f} too narrow for "
                           f"rlist {self.plan.rlist:.3f}")
        forced = os.environ.get("DDCMD_SHARD_ENGINE", "")
        if forced == "nlist":
            return "nlist"
        if forced == "pallas" and why:
            raise ValueError(f"DDCMD_SHARD_ENGINE=pallas infeasible: {why}")
        return "nlist" if why else "pallas"

    def _live_geom(self) -> np.ndarray:
        """The live box as the step takes it: (3,) lengths or the (3, 3)
        h, f64 on the host."""
        return self.Lv.cpu().numpy().astype(np.float64)

    def _live_L(self) -> np.ndarray:
        """The live box's lengths, the diagonal of h (what the gathered
        view's box.lengths reads)."""
        g = self._live_geom()
        return g if g.ndim == 1 else np.diagonal(g).copy()

    def _cell_tables(self):
        """(tables, tmap) of the cells engine: the MARTINI LJ tables
        collapsed to scalars when the deck uses one type (scalar
        parameters in the kernel)."""
        tables, tmap = self.tables, self._tmap
        if self._ptype == "MARTINI":
            n = self.sysdef.state.n_local
            used = np.unique(tmap[self.sysdef.state.species[:n].numpy()])
            if len(used) == 1:
                t0 = int(used[0])
                tables = dict(tables, **{
                    k: tables[k][t0:t0 + 1, t0:t0 + 1]
                    for k in ("sigma", "eps", "shift")})
                tmap = np.zeros_like(tmap)
        return tables, tmap

    def _build_step_fns(self):
        """Pick the engine at the LIVE box (at every replan and
        rebalance, JAX _build_step_fns :728-747) and build its step:
        the extended cell grid of the cells engine, or the global cell
        grid of the list engine, planned on the current positions with
        the ghost-duplication factor (JAX :204-222)."""
        sd = self.sysdef
        geom = self._live_geom()
        L = lb_frame(geom)[0]
        self.shard_engine = self._pick_shard_engine(L)
        common = dict(
            bonded_plan=self._bonded_plan, bonded_left=self._bonded_left,
            cons_templates=self._cons_templates,
            cons_tables=self._cons_tables, mol_gids=self._mol_gids,
            barostat=self.barostat, skin=sd.neighbor_deltaR,
            has_berendsen=sd.group_table.has_berendsen, **self._dynamics)
        if self.shard_engine == "pallas":
            self.cplan = plan_shard_cells(
                L, self.shape, sd.rcut_max, sd.neighbor_deltaR,
                sd.state.n_local, density_safety=self._density_safety,
                plan_margin=_NPT_PLAN_MARGIN if self._dyn_box else 1.0,
                walls=self.plan.walls)
            tables, tmap = self._cell_tables()
            self.step_fn = BrickStepCells(
                self.mesh, self.plan, self.cplan, tables, self.coeffs,
                sd.cfg.dt, L, tmap, sd.random_seed, self.chunk_steps,
                coulomb=self._coulomb, force_kind=self.force_kind,
                excl=self._excl_vals is not None, **common)
            return
        self.cplan = None
        self.grid = self._plan_grid(geom)
        self.step_fn = BrickStepList(
            self.mesh, self.plan, self.grid, self.tables, self.coeffs,
            sd.cfg.dt, geom, self._tmap, sd.random_seed, self.chunk_steps,
            force_kind=self.force_kind, excl=self._exgid is not None,
            dtype=self.dtype, **common)

    def _plan_grid(self, geom):
        """The list engine's global CellGrid at box geom, its occupancy
        measured on the current positions (the host arrays' before they
        are distributed, else the gathered rows; in the load-balance frame,
        whose axes the cells bin) times the ghost-duplication factor of a
        halo window wrapping a small box, and the replan ladder's
        growth."""
        sd = self.sysdef
        n = sd.state.n_local
        r = (self.gather_by_gid(("r",))["r"] if self.fields is not None
             else self._host_arrays["r"])
        L, r = lb_frame(geom, r)
        rlist = self.plan.rlist
        spans = [min(1.0, rlist / (L[a] / self.shape[a])) for a in range(3)]
        # an axis of one brick ships no ghosts (the JAX package counts
        # its window there too, which inflates the grid of a (1,1,1)
        # mesh 2.6x on the water box)
        dup = float(np.prod([
            max(1.0, (L[a] / self.shape[a]) * (1 + 2 * spans[a]) / L[a])
            if self.shape[a] > 1 else 1.0 for a in range(3)]))
        return CellGrid.plan(
            L, sd.rcut_max, sd.neighbor_deltaR, n,
            self.plan.local_cap + self.plan.ghost_cap, positions=r,
            occupancy_factor=dup * self._grid_growth,
            plan_margin=_NPT_LIST_MARGIN if self._dyn_box else 1.0)

    def _distribute(self, arrays):
        """This rank's brick of the host arrays at the live box, on the
        device, with the engine's exclusion field: the in-kernel channels
        (excl) of the cells engine, the partner gids (exgid) of the list
        engine; r0 (the drift guard's origin) is the position, pe zero
        until the first energy."""
        n = self.sysdef.state.n_local
        arrays = dict(arrays, r0=arrays["r"],
                      pe=np.zeros(n, np.asarray(arrays["r"]).dtype))
        if self.shard_engine == "pallas" and self._excl_vals is not None:
            arrays["excl"] = self._excl_vals[:n]
        if self.shard_engine == "nlist" and self._exgid is not None:
            arrays["exgid"] = self._exgid
        buf, mask, _ = distribute_bricks(arrays, self._live_geom(), self.plan)
        cap, rank = self.plan.local_cap, self.mesh.rank
        rows = slice(rank * cap, (rank + 1) * cap)
        self.fields = {k: torch.as_tensor(v[rows], device=self.device)
                       for k, v in buf.items()}
        self.mask = torch.as_tensor(mask[rows], device=self.device)
        self.rows_home = True

    def gather_by_gid(self, names=("r", "v")) -> dict:
        """Every rank's owned rows of the named fields (and "f") on the
        host, in the system's row order (the pio gather analog: rows
        keyed by their own gid, the state's, which a GIDSHUFFLE leaves
        as it is).  Collective."""
        m = self.mesh.all_gather(self.mask.to(torch.int64)).cpu().numpy()
        m = m.reshape(-1).astype(bool)
        g = self.mesh.all_gather(self.fields["gid"]).cpu().numpy()
        g = g.reshape(-1)[m]
        col = self._gid
        pos = {int(x): i for i, x in enumerate(col)}
        idx = np.fromiter((pos[int(x)] for x in g), dtype=np.int64,
                          count=len(g))
        out = {}
        for k in names:
            t = self.f if k == "f" else self.fields[k]
            a = self.mesh.all_gather(t).cpu().numpy()
            a = a.reshape((-1,) + a.shape[2:])[m]
            full = np.zeros((len(col),) + a.shape[1:], a.dtype)
            full[idx] = a
            out[k] = full
        return out

    def first_energy(self) -> float:
        """Forces, per-row potential energies and energy of the current
        state at the live box; keeps the molecular virial diagonal the
        next Berendsen step reads, the virial plus the kinetic tensor
        (mesh-wide) the next NPTGLF or NGLFNK step's pressure reads, and
        the energy the GLOBAL_ENERGY targets read."""
        self.f, e, virial, ov, pe = self.step_fn.first_forces(
            self.fields, self.mask, self.Lv)
        if bool(ov):
            raise RuntimeError("neighbor overflow at first energy")
        self.fields = dict(self.fields, pe=pe)
        self.vird = torch.diagonal(virial).clone()
        if self.step_fn.kind != "nglf":
            fm = self.mask.to(self.dtype)
            tion = kinetic_terms(self.fields["v"], self.fields["mass"], fm)[1]
            self.ptens = virial + self.mesh.psum(tion)
        e = float(e)
        if self._ge_groups:
            self._eion_last = e
        return e

    def box_state(self) -> dict:
        """The box and barostat state the next step reads (the chunks'
        carry, BrickStepBase.chunk): Lv, vird, zeta, bdot, ptens."""
        return dict(Lv=self.Lv, vird=self.vird, zeta=self.zeta,
                    bdot=self.bdot, ptens=self.ptens)

    def _set_box_state(self, dyn: dict):
        self.Lv, self.vird, self.zeta, self.bdot, self.ptens = (
            dyn[k] for k in ("Lv", "vird", "zeta", "bdot", "ptens"))

    def _time(self, loop: int | None = None) -> float:
        """The run's time at `loop` (the current loop by default;
        internal units): the one clock of the host and the step's
        hooks."""
        sd = self.sysdef
        loop = self.loop if loop is None else loop
        return (loop - sd.cfg.loop) * sd.cfg.dt + sd.cfg.time

    def _refresh(self):
        """The group coefficients at the dispatch's start time with the
        live GLOBAL_ENERGY targets (from the last accepted row's energy),
        into the step engine: Simulation's once-a-dispatch refresh."""
        if not self._refresh_coeffs:
            return
        sd = self.sysdef
        self.coeffs = live_coefficients(
            sd, self._time(), self.dtype, self.device,
            global_energy_teq(self._ge_groups, self._ge_total,
                              self._eion_last, sd.state.n_local))
        self.step_fn.coeffs = self.coeffs

    def _box_lam(self, steps: int):
        """The prescribed box(t) of the next `steps` steps as (E, M, h_ref)
        on the device (box_time_factors at the live time and mesh-wide
        volume): step i's box is (E[i] * h_ref) @ M[i], h_ref the
        dispatch's first box; under the Berendsen barostat the one-step
        factors go onto the live box each step (h_ref None), as
        Simulation's dispatch does.  None without a box(t)."""
        sd = self.sysdef
        bt = sd.box_time
        if bt is None:
            return None
        vol = (float(geom_volume(self.Lv)) if bt["mode"] == "volume"
               else 0.0)
        E, M = (torch.as_tensor(x, dtype=self.dtype, device=self.device)
                for x in box_time_factors(bt, self._time(), sd.cfg.dt, steps,
                                          vol, sd.state.n_local))
        if self.barostat is not None:
            return (E[:1].expand(steps, 3, 3), M[:1].expand(steps, 3, 3),
                    None)
        return E, M, torch.as_tensor(live_h(self._live_geom()),
                                     dtype=self.dtype, device=self.device)

    def _print_scalars(self, scalars, print_fn, loop0):
        """One line per printrate row: energies per particle, T over
        3 n - n_constraints degrees of freedom, and the pressure as the
        single-device printinfo computes it -- molecular, (tr W + 3
        N_mol kB T) / 3V, when the deck's PRINTINFO asks for it, else
        (tr W + 2 Ekin) / 3V -- in the PRINTINFO pressure unit, and the
        volume (internal units)."""
        sd = self.sysdef
        if not (print_fn and sd.cfg.printrate):
            return
        n = sd.state.n_local
        pinfo = self.printinfo
        for j in range(scalars.shape[0]):
            loop = loop0 + j + 1
            if loop % sd.cfg.printrate:
                continue
            e_pot, rk, tr_vir, vol = (float(scalars[j, 0]),
                                      float(scalars[j, 1]),
                                      float(scalars[j, 2]),
                                      float(scalars[j, 6]))
            T = 2.0 * rk / ((3.0 * n - sd.n_constraints) * U.kB)
            if pinfo.print_molecular_pressure:
                p = (tr_vir + 3.0 * self.n_molecules * U.kB * T) / (3.0 * vol)
            else:
                p = (tr_vir + 2.0 * rk) / (3.0 * vol)
            print_fn(f"{loop:10d} epot/N={e_pot / n:14.6f} "
                     f"ekin/N={rk / n:12.6f} T={T:10.2f} "
                     f"P={pinfo.c_press * p:14.6f} V={vol:12.4f}")

    def _dispatch(self, kind: str, n_super: int = 0, steps: int = 0):
        """One dispatch from the current state, one device-to-host read
        at its end: (new state (fields, mask, f, box_state), scalars
        (k, SCALAR_COLS) numpy, overflow, steps).  kind "super" runs
        n_super chunks of steps / n_super steps, "chunk" one chunk of
        `steps` steps (chunk_steps when 0), "step" one step of the fixed
        box without migration."""
        st = self.step_fn
        dyn = self.box_state()
        box_lam = None if kind == "step" else self._box_lam(
            steps or self.chunk_steps)
        if kind == "super":
            state, scal, ov = st.superchunk(
                self.fields, self.mask, self.f, dyn, self.loop, n_super,
                steps // n_super, box_lam)
        elif kind == "chunk":
            *state, scal, ov = st.chunk(self.fields, self.mask, self.f, dyn,
                                        self.loop, steps or None, box_lam)
        else:
            fields, f, scal, ov = st.step(self.fields, self.mask, self.f,
                                          self.loop)
            state, scal = (fields, self.mask, f, dyn), scal[None]
        host = torch.cat([scal.reshape(-1),
                          ov.to(scal.dtype).reshape(1)]).cpu().numpy()
        rows = host[:-1].astype(np.float64).reshape(-1, SCALAR_COLS)
        return tuple(state), rows, bool(host[-1]), rows.shape[0]

    def run(self, n_loops: int, *, migrate_rate: int | None = None,
            print_fn=None, max_steps_per_dispatch: int | None = None):
        """Chunked dispatch: ddc updateRate steps plus one migration per
        chunk; with max_steps_per_dispatch >= 2 chunks, that many chunks
        per dispatch (the superchunk).  Every dispatch ends on each host
        rate's next multiple (_host_rates; the superchunk runs only where
        it fits before it) and at n_loops, in a shorter chunk.  After each
        dispatch the outputs at their rates (_outputs), then each SIMULATE
        transform= whose rate divides the loop (apply_transform), in
        Simulation.run's order; at the end every analysis writes once
        more, as Simulation.run does.

        migrate_rate (the JAX package's run(migrate_rate=)): None or
        chunk_steps changes nothing; under a moving box it is the chunk
        length; under NVT the run dispatches one step at a time (no
        superchunk) and migrates on each loop migrate_rate divides.  Steps
        away from their last migration for longer than a chunk run under
        the drift guard.  An overflowing dispatch, the per-step path's and
        its migration's too (the JAX per-step path raises), rolls back to
        the state before it (the box and virial diagonal too) and
        escalates: (1) host redistribute, (2) replan at the live box, (3)
        raise.  Before each dispatch the group coefficients are refreshed
        at its start time (_refresh); a box(t) deck's dispatch takes its
        factors from there (_box_lam)."""
        if self.f is None:
            self.first_energy()
        done = 0
        k = self.chunk_steps
        mr = k if migrate_rate is None else int(migrate_rate)
        if mr < 1:
            raise ValueError(f"migrate_rate={migrate_rate}")
        per_step = mr != k and not self._dyn_box
        if self._dyn_box:
            k = mr
        # with load balance at a rate no superchunk spans a rebalance:
        # chunks, each preceded by the rebalance when its loop is due
        # (JAX parallel_sim.py:499-555)
        rate = self.lb_rate
        next_lb = self.loop - self.loop % rate + rate if rate else None
        M = (max_steps_per_dispatch // k if max_steps_per_dispatch
             and max_steps_per_dispatch >= 2 * k and not rate
             and not per_step else 0)
        host_rates = self._host_rates()
        redis_tries = 0
        while done < n_loops:
            room = n_loops - done
            for r_ in host_rates:
                room = min(room, r_ - self.loop % r_)
            if per_step:
                kind, steps = "step", 1
            elif M and room >= M * k:
                kind, steps = "super", M * k
            else:
                kind, steps = "chunk", min(k, room)
            if kind != "super" and next_lb is not None \
                    and self.loop >= next_lb:
                self.rebalance()
                next_lb += rate
            self._refresh()
            t0 = _time.perf_counter()
            state, rows, ov, steps = self._dispatch(kind, M, steps)
            migrated = kind != "step"
            if not ov and per_step and (self.loop + 1) % mr == 0:
                *moved, ov = self.step_fn.migrate(*state[:3], state[3]["Lv"])
                state = (*moved, state[3])
                migrated = True
            seconds = _time.perf_counter() - t0
            if ov:
                redis_tries += 1
                if redis_tries > 2:
                    raise RuntimeError(f"overflow in {kind} at loop "
                                       f"{self.loop}")
                if redis_tries == 1:
                    self.redistribute()
                else:
                    self.replan()
                continue
            redis_tries = 0
            if not np.isfinite(rows[:, :2]).all():
                raise FloatingPointError(
                    f"non-finite energy after loop {self.loop} (reference "
                    "kill switch, masters.c:470-475)")
            self.fields, self.mask, self.f = state[:3]
            self._set_box_state(state[3])
            self._last_row = rows[-1]
            if self._ge_groups:
                self._eion_last = float(rows[-1, 0])
            self.rows_home = migrated
            self._print_scalars(rows, print_fn, self.loop)
            self.loop += steps
            done += steps
            self.dispatch_log.append((steps, seconds))
            self._outputs(steps)
            for _, tobj, rate_t in self.transforms:
                if rate_t and self.loop % rate_t == 0:
                    self.apply_transform(tobj)
        if self.analyses:
            view = self.view()
            if self.mesh.rank == 0:
                for a in self.analyses:
                    a.output(view, self.run_dir)
        return self

    # -- outputs at their rates ---------------------------------------------

    def _host_rates(self) -> list[int]:
        """The non-zero rates a dispatch ends on: each transform's, each
        analysis's eval_rate and outputrate, and printrate when the
        per-group files are written (Simulation writes them only at
        dispatch ends printrate divides)."""
        rates = [rate for _, _, rate in self.transforms]
        for a in self.analyses:
            rates += [a.eval_rate, a.output_rate]
        if self._group_files():
            rates.append(self.sysdef.cfg.printrate)
        return [r for r in rates if r]

    def _group_files(self) -> bool:
        sd = self.sysdef
        return len(sd.groups) > 1 and bool(sd.cfg.printrate)

    def _outputs(self, k: int):
        """What a dispatch of k steps that ended at self.loop writes: the
        graphs line, the per-group files at printrate, the analyses'
        evaluations and outputs at their rates (Simulation.run's order).
        Collective."""
        loop = self.loop
        if self.printinfo.print_graphs:
            self._emit_graphs(k)
        if self._group_files() and loop % self.sysdef.cfg.printrate == 0:
            self._emit_group_files()
        due = [(a, bool(a.eval_rate and loop % a.eval_rate == 0),
                bool(a.output_rate and loop % a.output_rate == 0))
               for a in self.analyses]
        due = [d for d in due if d[1] or d[2]]
        if not due:
            return
        view = self.view()
        rank0 = self.mesh.rank == 0
        for a, ev, out in due:
            if ev:
                if hasattr(a, "eval_sharded") and a.shardable(self):
                    a.eval_sharded(self)
                elif rank0:
                    a.eval(view)
            if out and rank0:
                a.output(view, self.run_dir)

    def _emit_graphs(self, k: int):
        """One graphs line a dispatch (write_graphs_line, Simulation's
        columns): the mesh-wide nlocal, on the cells engine the mesh's
        core cells, their cap and the pair slots its sweep covers, then
        the owned count of each brick (what the rebalance reads).  Rank 0
        writes.  Collective."""
        owned = self.mesh.all_gather(self.mask.sum().to(torch.int64)
                                     .reshape(1)).reshape(-1).cpu().tolist()
        if self.mesh.rank != 0:
            return
        cells = None
        if self.shard_engine == "pallas":
            cp = self.cplan
            ncell = cp.n_prog * self.mesh.size
            n_stencil = cp.stencil_packed.shape[1] // 4
            cells = (ncell, cp.cap, ncell * n_stencil * cp.cap * cp.cap)
        write_graphs_line(
            self.run_dir, self.loop, self._time(), sum(owned),
            k, cells, " owned=" + ",".join(str(int(x)) for x in owned))

    def _emit_group_files(self):
        """Per-group temperature and energies (write_group_row), each
        group's count and energies summed over the owned rows of every
        rank in one all-reduce (f64), no rows gathered.  Rank 0 writes."""
        sd = self.sysdef
        fl, m = self.fields, self.mask
        idx = torch.tensor([g.index for g in sd.groups], device=self.device)
        sel = ((fl["group"].to(torch.int64)[:, None] == idx[None, :])
               & m[:, None]).to(torch.float64)
        v = fl["v"].double()
        ke = 0.5 * fl["mass"].double() * (v * v).sum(1)
        part = torch.stack([sel.sum(0), (ke[:, None] * sel).sum(0),
                            (fl["pe"].double()[:, None] * sel).sum(0)], 1)
        tot = self.mesh.psum(part).cpu().numpy()
        if self.mesh.rank != 0:
            return
        for g, (cnt, ke_g, pe_g) in zip(sd.groups, tot):
            cnt = int(round(cnt))
            if cnt:
                write_group_row(self.run_dir, g.name, self.loop, cnt, ke_g,
                                pe_g)

    # -- transforms -----------------------------------------------------------

    def apply_transform(self, tobj):
        """Apply the TRANSFORM object `tobj` to the mesh's state, with
        Simulation.apply_transform's semantics (transform.c:153-181, which
        the reference's parallel run applies; the JAX mesh applies none).
        Collective: r and v are gathered by gid at the live box, rank 0
        applies the transform on the host (host_transform: a REPLICATE
        on a bonded deck makes each molecule whole first) and broadcasts
        its result -- gids, r, v, masses, species and group names, h --
        or its error, so every rank takes one state (THERMALIZE's
        randomizeSeed draws from os.urandom, CUSTOM reads files) or
        raises one error.

        Fast path, the same particles, species and box kind
        (same_particles): the new r and v, the new box (when it moved,
        the brick plan's capacities and the engine are planned again at
        its spans; walls and Voronoi centres are fractions of it and
        stay), and the collection's new gids and group names (the rows
        keep their own key, the state's gids, as Simulation's state keeps
        them; gathers key by it, the files write the collection's); the
        rows are distributed again.  Otherwise the system is rebuilt
        (rebuild_system: a new State; on a count change the topology is
        built anew before anything changes, so a transform that keeps
        part of a residue raises ValueError on every rank and leaves the
        run as it was) and derived anew (_derive: the box kind, the load
        balance from the new positions, the plan's capacities, the
        topology's gid tables, the dynamics, the engine and its step),
        the replan ladder reset.  Then the first energy.  Returns the
        transform's host result, a TransformContext (f64, the rows in
        the system's new order)."""
        from ..core.box import Box
        from ..transforms.registry import TransformContext

        sd = self.sysdef
        g = self.gather_by_gid(("r", "v"))
        out = None
        if self.mesh.rank == 0:
            try:
                ctx, replicate = host_transform(
                    sd, tobj, g["r"].astype(np.float64),
                    g["v"].astype(np.float64),
                    self._host_arrays["mass"].astype(np.float64),
                    live_h(self._live_geom()),
                    sd.box.pbc_mask.numpy().astype(np.float64),
                    time=self._time(),
                    rate=next((r_ for _, t, r_ in self.transforms
                               if t is tobj), 1),
                    run_dir=self.run_dir, base_dir=self.base_dir)
                out = (dict(r=ctx.r, v=ctx.v, gid=ctx.gid, mass=ctx.mass,
                            species_names=ctx.species_names,
                            group_names=ctx.group_names, h=ctx.h),
                       replicate, None)
            except Exception as err:
                out = (None, False, _portable(err))
        res, replicate, err = self._broadcast(out)
        if err is not None:
            raise err
        ctx = TransformContext(**res)
        box = Box.from_h(ctx.h, pbc=sd.box.pbc, dtype=self.dtype,
                         device="cpu")
        if same_particles(sd, ctx, box, not self._tri):
            self._reupload(ctx)
        else:
            rebuild_system(self.db, sd, tobj, ctx, box, replicate,
                           dtype=self.dtype, device="cpu")
            self._density_safety, self._grid_growth = 1.3, 1.0
            self._derive()
        self.f = None
        self.first_energy()
        return ctx

    def _reupload(self, ctx):
        """The fast path of apply_transform: ctx's r, v and box into the
        host arrays and the step, the collection's gids and group names,
        then the rows distributed at the new box."""
        geom = ctx.h if self._tri else np.diagonal(ctx.h).copy()
        moved = not np.array_equal(geom, self._live_geom())
        if moved:
            # checked before anything changes
            L = lb_frame(geom)[0]
            self._check_reach(L)
        col = self.sysdef.collection
        col.gid = ctx.gid
        col.group_names = ctx.group_names
        dt_ = self._host_arrays["r"].dtype
        self._host_arrays = dict(self._host_arrays, r=ctx.r.astype(dt_),
                                 v=ctx.v.astype(dt_))
        self.Lv = torch.as_tensor(geom, dtype=self.dtype, device=self.device)
        self.fields = None
        if moved:
            self.plan = self._brick_plan(L, self.plan.walls,
                                         self.plan.voronoi)
            self._build_step_fns()
        self._distribute(self._host_arrays)

    def _broadcast(self, obj):
        """Rank 0's picklable `obj` on every rank (collective; obj itself
        on a mesh of one)."""
        if self.mesh.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=0,
            device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def redistribute(self, g=None):
        """Host-exact re-assignment of every particle to its brick under
        the current walls or Voronoi centres at the live box (no
        replan): recovers from a migration or halo overflow, and from an
        ORCB or Voronoi containment flag.  g: the gathered r and v, when
        the caller has them."""
        g = self.gather_by_gid(("r", "v")) if g is None else g
        arrays = dict(self._host_arrays, r=g["r"], v=g["v"])
        self._distribute(arrays)
        self.f = None
        self.first_energy()

    def rebalance(self):
        """Recompute the decomposition from the CURRENT positions (the
        JAX package's parallel_rebalance, parallel_sim.py:926-1009;
        loadBalance at rate, loadBalance.c:32-85): the tensor or
        bisection walls, or one balance_step of the Voronoi centres (a
        density-weighted Lloyd move, re-clamped, with its margins);
        then pick the engine and plan its grid under it, and
        redistribute.  Every rank computes the same decomposition from
        the same gathered positions."""
        import dataclasses

        g = self.gather_by_gid(("r", "v"))
        L, r_lb = lb_frame(self._live_geom(), g["r"])
        if self._lb_kind == "voronoi":
            from ..parallel.voronoi import balance_step

            vor = self.plan.voronoi
            scale = L / np.asarray(vor["L0"], np.float64)
            centers, margins = balance_step(
                np.asarray(vor["centers"]) * scale[None, None, None, :],
                np.asarray(r_lb, np.float64), L, self.shape,
                self.plan.rlist, eta=self._lb_eta)
            self.plan = dataclasses.replace(
                self.plan, voronoi=dict(centers=centers, margins=margins,
                                        L0=L.copy()))
        else:
            self.plan = dataclasses.replace(
                self.plan, walls=self._lb_walls(r_lb, L, self.plan.rlist))
        self._check_reach(L)
        self._build_step_fns()
        self.redistribute(g)
        self.n_rebalance += 1

    def _plan_key(self):
        """What a replan can change: the engine and its grid's shape."""
        if self.shard_engine == "pallas":
            return ("pallas", self.cplan.ncore, self.cplan.cap)
        return ("nlist", self.grid.ncells, self.grid.cell_capacity,
                self.grid.max_neighbors)

    def replan(self):
        """Pick the engine again and replan its grid at the LIVE box (a
        barostat-compressed box can take a cell edge below rlist; fewer,
        larger cells restore the one-shell stencil), with 1.3x the room
        when that changes nothing (the cells engine's density safety,
        the list grid's occupancy: a larger cell capacity and list
        width, as the single-device run loop grows them), and
        redistribute.  A brick narrower than rlist on an axis of three or
        more bricks at the live box makes the decomposition itself
        infeasible: raise."""
        L = lb_frame(self._live_geom())[0]
        try:
            self._check_reach(L)
        except ValueError as err:
            raise RuntimeError(f"brick decomposition infeasible at the live "
                               f"box (spans {L}): {err}") from None
        old = self._plan_key()
        self._build_step_fns()
        if self._plan_key() == old:
            if self.shard_engine == "pallas":
                self._density_safety *= 1.3
            else:
                self._grid_growth *= 1.3
            self._build_step_fns()
        self.redistribute()

    # -- checkpoint, gathered view, analyses --------------------------------

    def _barrier(self):
        if self.mesh.size > 1:
            dist.barrier()

    def _view_state(self, g: dict):
        """StepState at the live box with the rows of the gathered fields
        `g` (r, v, f, pe) on this rank's device, the static fields where
        the system holds them, and the energy of the last accepted step
        (e_pot, rk and its mesh-wide virial from the step's row, the
        kinetic tensor from the gathered v; zero before the first
        dispatch): the JAX package's parallel_view state
        (parallel_sim.py:1079-1114), with what printStress's STRESSWRITE
        and the per-row analyses read."""
        from ..core.box import Box
        from ..core.energy import EnergyInfo, kinetic_terms
        from ..integrators.nglf import StepState

        sd = self.sysdef
        n = sd.state.n_local
        dev = self.device
        dt_ = sd.state.r.dtype
        rep = {}
        for k, a in g.items():
            t = getattr(sd.state, k).to(dev).clone()
            t[:n] = torch.as_tensor(a, dtype=t.dtype, device=dev)
            rep[k] = t
        state = sd.state.replace(**rep)
        box = Box.from_h(live_h(self._live_geom()), pbc=sd.box.pbc,
                         dtype=dt_, device=dev)
        energy = EnergyInfo.zero(dt_, dev)
        row = self._last_row
        if row is not None:
            def t(x):
                return torch.as_tensor(x, dtype=dt_, device=dev)

            tion = (kinetic_terms(state.v, state.mass.to(dev),
                                  state.fmask)[1]
                    if "v" in g else energy.tion)
            energy = EnergyInfo(eion=t(row[0]), rk=t(row[1]),
                                virial=t(row[7:16]).reshape(3, 3), tion=tion,
                                number=t(float(n)))
        return StepState(state=state, box=box, energy=energy,
                         loop=self.loop, time=self._time(), zeta=self.zeta,
                         bdot=self.bdot)

    def view(self):
        """A Simulation-shaped view of the mesh (sysdef, ss, device) with
        r, v, f and pe gathered by gid (every rank gets it; collective),
        on which the analysis registry's classes evaluate unchanged -- the
        dataExchange / getRemoteData analog of the JAX package's
        parallel_view."""
        names = ("r", "v", "pe") + (("f",) if self.f is not None else ())
        ss = self._view_state(self.gather_by_gid(names))
        return SimpleNamespace(sysdef=self.sysdef, ss=ss, device=self.device,
                               db=self.db, parallel_plan=self.plan)

    def write_checkpoint(self, run_dir: str = ".") -> str:
        """Write a snapshot directory that restarts under Simulation or the
        mesh, in either package (writeRestart for the mesh, JAX
        parallel_sim.py:801-921): by default each rank writes the atoms#
        shard of its OWNED rows (pio's N-writer layout, ddcMD
        src/simulate.c:212), and after a barrier rank 0 patches shard 0's
        header to the global nfiles and nrecord, then writes the restart
        and the pxyz of the live plan.  Binary checkpoint modes and
        DDCMD_SHARD_WRITERS=0 gather by gid to one writer on rank 0.
        Collective; returns the snapshot directory."""
        from ..io.restart import write_checkpoint as _wc

        sd = self.sysdef
        sysobj = sd.db.get(sd.cfg.system_name, "SYSTEM")
        colobj = sd.db.find(sysobj.get_str("collection", "collection"),
                            "COLLECTION")
        mode = colobj.get_str("mode", "VARRECORDASCII") if colobj \
            else "VARRECORDASCII"
        sharded = (os.environ.get("DDCMD_SHARD_WRITERS", "1") != "0"
                   and mode.upper() not in ("FIXRECORDBINARY", "BINARY"))
        rank = self.mesh.rank
        if sharded:
            ss = self._view_state({})
            writer = self._shard_writer()
        else:
            ss = self._view_state(self.gather_by_gid(("r", "v")))
            # the records carry the collection's gids, as the shards do
            gid = ss.state.gid.copy()
            gid[:sd.state.n_local] = gid64(sd.collection.gid)
            ss = ss.replace(state=ss.state.replace(gid=gid))
            writer = None
        shim = SimpleNamespace(sysdef=sd, ss=ss, parallel_plan=self.plan)
        if rank == 0:
            snap = _wc(shim, run_dir, atoms_writer=writer)
        else:
            ndig = max(sd.cfg.nLoopDigits, 6)
            snap = os.path.join(run_dir, f"snapshot.{self.loop:0{ndig}d}")
            if sharded:
                os.makedirs(snap, exist_ok=True)
                time_fs = ((sd.cfg.time + (self.loop - sd.cfg.loop)
                            * sd.cfg.dt) * U.TIME_TO_FS)
                writer(snap, mode, self.loop, time_fs)
        self._barrier()
        return snap

    def _shard_writer(self):
        """atoms_writer of write_checkpoint: this rank's atoms#<rank> from
        its owned rows (any record order: readers key by gid), a barrier,
        then on rank 0 shard 0's header patched to the mesh-wide nfiles
        and nrecord (the JAX package's _make_sharded_atoms_writer, with
        one writer a rank instead of one a device).  The record counts
        are summed before anything is written."""
        from ..io.collection import _strip_header, write_collection

        sd = self.sysdef
        col = sd.collection
        m = self.mask
        n_own = int(m.sum())
        total = int(self.mesh.psum(m.sum().to(torch.int64).reshape(1))[0])
        g64 = self.fields["gid"][m].cpu().numpy().astype(np.int64)
        r = self.fields["r"][m].cpu().numpy().astype(np.float64)
        v = self.fields["v"][m].cpu().numpy().astype(np.float64)
        # each row's place in the system by its own key, then the
        # collection's gid and names there
        pos = np.argsort(self._gid, kind="stable")
        idx = pos[np.searchsorted(self._gid, g64, sorter=pos)]
        names = gid64(col.gid)[idx]
        rank, size = self.mesh.rank, self.mesh.size
        h = live_h(self._live_geom())

        def pick(names):
            return [names[i] for i in idx]

        def writer(snapdir, mode, loop, time_fs):
            path = os.path.join(snapdir, "atoms#%06d" % rank)
            write_collection(
                path, gid=names.astype(np.uint64),
                species_names=pick(col.species_names),
                group_names=pick(col.group_names),
                class_names=pick(col.class_names), r=r, v=v, h=h,
                loop=loop, time_fs=time_fs,
                group_list=[g.name for g in sd.groups],
                species_list=[s.name for s in sd.species],
                gid_format="hex" if sd.cfg.gidFormat == "hex" else "dec",
                datatype=mode, precision=sd.cfg.checkpointprecision)
            if rank > 0:
                # continuation shards carry records only (the FILEHEADER
                # lives in shard 0)
                with open(path, "rb") as f:
                    blob = f.read()
                with open(path, "wb") as f:
                    f.write(_strip_header(blob))
            self._barrier()
            if rank == 0:
                with open(path, "rb") as f:
                    blob = f.read()
                blob = blob.replace(b"nfiles=1;", b"nfiles=%d;" % size, 1)
                blob = blob.replace(b"nrecord=%d;" % n_own,
                                    b"nrecord=%d;" % total, 1)
                with open(path, "wb") as f:
                    f.write(blob)

        return writer

    def run_analyses(self, run_dir: str = ".") -> list:
        """Evaluate every ANALYSIS object of the deck once on the current
        state and write its output (analysisMaster for the mesh, JAX
        parallel_sim.py:1117-1145).  PAIRCORRELATION, VCMWRITE,
        KINETICENERGYDISTN, ZDENSITY and SSF sum owned-row partials over
        the mesh (eval_sharded, on every rank); the others evaluate on
        the gathered view.  Where the JAX package catches any error of
        eval_sharded and evaluates the gathered view instead, the port
        decides up front -- PAIRCORRELATION with rmax beyond rlist, past
        the halo, takes the gathered path -- and raises on any other
        error.  Rank 0 writes the files.  Collective; returns the names
        evaluated."""
        import warnings

        from ..analysis.registry import build_analysis

        view = self.view()
        done = []
        for obj in self.db.by_class("ANALYSIS"):
            try:
                a = build_analysis(obj.name, obj)
            except Exception as err:
                warnings.warn(f"analysis {obj.name} skipped: {err}")
                continue
            if hasattr(a, "eval_sharded") and a.shardable(self):
                a.eval_sharded(self)
            elif self.mesh.rank == 0:
                a.eval(view)
            if self.mesh.rank == 0:
                a.output(view, run_dir)
            done.append(obj.name)
        return done
