"""Deck-driven MD over a brick mesh, one rank per brick.

Counterpart of ddcmd_tpu/run/parallel_sim.py:ParallelSimulation for the
decks of the Martini water box, the Martini bilayer, PAIR Lennard-Jones
fluids and the EAM crystal:
`ddc DDC {lx=2; ly=2; lz=2;}` (the reference's domain lattice keywords,
ddc.c:35-137) or the `shape` argument selects the mesh, and each rank
runs parallel/brickstep_cells.BrickStepCells on its brick through the
extended-grid kernels (TPU kernels #6 and #7).

Covalent topologies (the bilayer) ride along keyed by global id: the
residue-template bonded terms in `rf_add` mode beside the pair kernel's
in-kernel exclusion mask, the template-batched RATTLE groups (or the
generic groups of a topology that is not template-regular) and the
multi-bead molecules of the molecular virial, all resolved per rank at
each rebuild (parallel/bonded_shard.py); migration is molecule-coherent,
the head bead of each chain deciding.  The NGLFCONSTRAINT family with
beta > 0 runs the Berendsen barostat in the NPT chunk, which carries
the live box and the molecular virial diagonal; the cell plan then keeps
an 8% shrink margin, and the overflow ladder replans against the live
box.

Ranks come from torch.distributed (the caller initialises the process
group: NCCL for CUDA tensors, one card per rank; gloo for the CPU).  A
(1, 1, 1) mesh needs no process group.  Every rank builds the system
from the deck, keeps the rows of its own brick, and runs the same host
loop; the per-step scalars and the overflow flag are mesh-wide, so all
ranks take the same decisions.

A PAIR deck runs as the JAX package runs it: the MARTINI kernel with the
species index as type and the reaction-field constants zero.  An EAM
deck runs its analytic form or its tabularFit=rational refit on #7.

The nonbond term is the deck's one MARTINI, EAM or PAIR potential,
selected by type as the JAX mesh selects it (parallel_sim.py:58-90);
NONE terms carry no force and are dropped.  Where the JAX mesh would
drop a force silently, the port raises naming item 25: RESTRAINT and
REFLECT, PAIRENERGY and ORDERSH (the JAX mesh ignores all four), a
second nonbond term, a deck with no nonbond term, and EAM it cannot run
(unfitted TABULAR, more than 4 species).

Deck features outside these paths raise NotImplementedError naming
their ROADMAP item: load balance (and with it the pxyz decomposition
restart), triclinic bricks and non-periodic axes (item 25: the JAX mesh
reads no pbc bit and would run such a deck fully periodic), an
exclusion component wider than the in-kernel encoding, a tabulated PAIR
or bricks narrower than the cell engine allows (the JAX package's brick
list engine make_brick_step, item 25), bonded terms that cross residue
instances (CHARMM junctions and CMAP: the JAX package's per-term gid
resolver, item 25), NGLFNEW with constraints (the JAX mesh projects
constraints only for CONSTRAINT integrators, its Simulation also for
NGLFNEW).  The kicks are the group kinds whose coefficients stay
constant (FREE, LANGEVIN, FROZEN, FIXEDVELOCITY, QUENCH, BERENDSEN with
its temperature summed over the ranks, a constant PISTON; the JAX mesh
takes it per brick); the other integrators and box motions (NPTGLF,
NGLFNK, the NVEGLF variants, box(t), EXTFORCE, the hook groups,
GLOBAL_ENERGY, Teq or vz schedules) raise naming item 25
(_refuse_dynamics), as do the NEXTFILE and NGLFTEST masters, printGraphs
and the per-group energy files (which the JAX mesh does not write;
Simulation writes them), and SIMULATE analysis= and PRINTINFO
printStress (Simulation runs them; the sharded analyses,
ddcmd_tpu/run/parallel_sim.py:1117-1148, are item 25's).  The checkpoint
writer, rebalance and the gathered view are not ported yet.
"""

from __future__ import annotations

import os
import time as _time

import numpy as np
import torch
import torch.distributed as dist

from ..core.molecule import build_molecule_class
from ..core.system import build_system
from ..objects import ObjectDB
from ..objects import units as U
from ..parallel.bonded_shard import (constraint_gid_tables,
                                     mesh_bonded_plan, molecule_gid_tables)
from ..parallel.brick import BrickPlan, distribute_bricks, gid64
from ..parallel.brickstep_cells import BrickStepCells
from ..parallel.mesh import BrickMesh
from ..parallel.shard_cells import plan_shard_cells
from ..potentials.eam import eam_device_tables
from ..potentials.martini import martini_device_tables
from ..potentials.pair import pair_device_tables
from .forces import (_excl_channels, bonded_tables,
                     wide_exclusion_component)
from .printinfo import PrintInfo
from .simulate import (_BAROSTAT_TYPES, _MASTER_TYPES, _NPT_TYPES,
                       _NVE_TYPES, refuse_unported_outputs,
                       uses_constraints)

_MESH_ITEM = "ROADMAP queue 1, item 25"
# NPT decks plan cells with shrink headroom (the JAX package's
# plan_shard_cells margin for NPT decks)
_NPT_PLAN_MARGIN = 1.08


def _cap(x: int) -> int:
    return ((int(x) + 7) // 8) * 8


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


class ParallelSimulation:
    """Sharded run of a Martini (water box, bilayer) or EAM deck over a
    brick mesh, NVT or Berendsen NPT."""

    def __init__(self, db: ObjectDB, base_dir: str = ".", *, shape=None,
                 device=None):
        self.device = dev = _mesh_device(device)
        sd = build_system(db, base_dir, dtype=torch.float32, device="cpu")
        self.sysdef = sd
        self.printinfo = PrintInfo.from_deck(db, sd.cfg.printinfo_name)
        refuse_unported_outputs(db, sd, self.printinfo)
        if sd.integrator_type in _MASTER_TYPES:
            # Simulation runs them; the JAX mesh has no such path
            raise NotImplementedError(
                f"integrator {sd.integrator_type}: the NEXTFILE / NGLFTEST "
                f"masters do not run under the mesh yet ({_MESH_ITEM})")
        self._refuse_dynamics(sd)
        if not sd.box.ortho:
            raise NotImplementedError(
                f"triclinic bricks are not ported yet ({_MESH_ITEM})")
        if sd.box.pbc & 7 != 7:
            raise NotImplementedError(
                f"pbc={sd.box.pbc} under the mesh: the JAX mesh reads no pbc "
                "bit and would run the deck fully periodic; non-periodic "
                f"bricks are not ported yet ({_MESH_ITEM})")
        if sd.integrator_type == "NGLFNEW" and uses_constraints(sd):
            raise NotImplementedError(
                "NGLFNEW with constraints under the mesh: the JAX mesh "
                "projects constraints only for CONSTRAINT integrators "
                "(parallel_sim.py:249), its Simulation also for NGLFNEW "
                "(simulate.py:270-272); the port takes neither rule here "
                f"({_MESH_ITEM})")

        sim = db.by_class("SIMULATE")[0]
        ddc = db.find(sim.get_str("ddc", "ddc"), "DDC")
        if ddc is not None and ddc.get_str("loadBalance", ""):
            raise NotImplementedError(
                "load balance under the mesh is not ported yet "
                f"({_MESH_ITEM}: parallel/loadbalance.py, voronoi.py)")
        if shape is None and ddc is not None and ddc.has("lx"):
            shape = (ddc.get_int("lx", 1), ddc.get_int("ly", 1),
                     ddc.get_int("lz", 1))
        if shape is None:
            shape = ((dist.get_world_size() if dist.is_initialized() else 1),
                     1, 1)
        self.shape = tuple(int(s) for s in shape)
        self.mesh = BrickMesh(self.shape, dev)
        n_dev = self.mesh.size

        ptype, parms = self._nonbond_term(sd)
        n = sd.state.n_local
        if ptype == "MARTINI":
            tables = martini_device_tables(parms, device=dev)
            tmap = np.asarray(parms.species_lj_type)
            self.force_kind = "martini"
            # uniform-LJ-type collapse: scalar parameters in the kernel
            used = np.unique(tmap[sd.state.species[:n].numpy()])
            if len(used) == 1:
                t0 = int(used[0])
                tables = dict(tables, **{
                    k: tables[k][t0:t0 + 1, t0:t0 + 1]
                    for k in ("sigma", "eps", "shift")})
                tmap = np.zeros_like(tmap)
        elif ptype == "PAIR":
            # the MARTINI kernel with zero reaction-field constants, the
            # species index as type (parallel_sim.py:74-92 of the JAX
            # package); the kernel reads no table
            if parms.table is not None:
                raise NotImplementedError(
                    "PAIR function=TableFunction under the mesh: the table "
                    "runs on the brick (N,K)-list engine (the JAX "
                    "package's make_brick_step), not ported yet "
                    f"({_MESH_ITEM})")
            tables = pair_device_tables(parms, device=dev)
            tmap = np.arange(len(sd.species))
            self.force_kind = "martini"
        else:
            # the kernels' own tables, and the refusal of a deck they
            # cannot take, are parallel/shard_cells.make_shard_eam_kernels'
            tables = eam_device_tables(parms, device=dev)
            tmap = np.arange(len(sd.species))
            self.force_kind = "eam"
        self.tables, self._tmap = tables, tmap
        self._coulomb = bool(np.any(sd.state.q[:n].numpy() != 0.0))

        L = sd.box.lengths.numpy().astype(np.float64)
        rlist = sd.rcut_max + sd.neighbor_deltaR
        # halo windows scale with rlist / brick width (parallel_sim.py:
        # 182-202 of the JAX package)
        per_dev = max(1, n // n_dev)
        width = min(L[a] / self.shape[a] for a in range(3))
        frac = min(1.0, rlist / width)
        halo_est = int(per_dev * (1 + 2 * frac) ** 2 * frac * 1.8) + 64
        self.plan = BrickPlan(
            shape=self.shape,
            local_cap=_cap(n) if n_dev == 1 else _cap(4 * n // n_dev),
            halo_cap=_cap(max(3 * n // n_dev // 2, halo_est)),
            migrate_cap=_cap(max(256, n // (4 * n_dev))), rlist=rlist)
        self._check_geometry(L, rlist)
        self.chunk_steps = max(1, int(sd.cfg.ddc_update_rate))
        self.coeffs = sd.group_table.coefficients(
            sd.cfg.time, 0.5 * sd.cfg.dt, device=dev)
        self._density_safety = 1.3
        gid = gid64(sd.collection.gid)
        self._setup_barostat(db, gid)
        self._setup_topology(gid)
        # the live box (moves under the barostat) and the last molecular
        # virial diagonal the next NPT step's lambda reads
        self.Lv = torch.as_tensor(L, dtype=torch.float32, device=dev)
        self.vird = torch.zeros(3, dtype=torch.float32, device=dev)
        self._build_step_fns()

        self._host_arrays = dict(
            r=sd.state.r[:n].numpy(), v=sd.state.v[:n].numpy(),
            q=sd.state.q[:n].numpy(), mass=sd.state.mass[:n].numpy(),
            species=sd.state.species[:n].numpy(),
            group=sd.state.group[:n].numpy(), gid=gid)
        if self._hgid is not None:
            self._host_arrays["hgid"] = self._hgid
        if self._excl_vals is not None:
            self._host_arrays["excl"] = self._excl_vals[:n]
        self._distribute(self._host_arrays)
        self.f = None
        self.loop = sd.cfg.loop
        # (steps, seconds) of each accepted dispatch, host clock around
        # work that ends in the dispatch's one device-to-host read
        self.dispatch_log: list[tuple[int, float]] = []

    # ------------------------------------------------------------------

    @staticmethod
    def _refuse_dynamics(sd):
        """The mesh's kicks are the affine group kinds whose coefficients
        do not change in time (FREE, LANGEVIN, FROZEN, FIXEDVELOCITY,
        QUENCH, BERENDSEN and a constant PISTON), which is what the JAX
        mesh's velocity_update calls compute (brickstep_pallas.py:332,
        346).  The JAX mesh reads the integrator type only for its plan
        margin and its Berendsen barostat (parallel_sim.py:214-217,272),
        passes its kicks no hook context and computes the coefficients
        once, so it runs NPTGLF and NGLFNK as NGLF, thermostats an NVEGLF
        deck and ignores box(t), EXTFORCE, the hook groups, GLOBAL_ENERGY
        and Teq or vz schedules (ROADMAP queue 3): each raises here,
        naming item 25."""
        gt = sd.group_table
        why = []
        if sd.integrator_type in _NPT_TYPES + _NVE_TYPES:
            why.append(f"integrator {sd.integrator_type}")
        if sd.box_time is not None:
            why.append(f"a prescribed box(t) ({sd.box_time['mode']})")
        why += [f"GROUP {g.name} of type {g.type}" for g in sd.groups
                if g.type in ("EXTFORCE", "SHEAR", "SHWALL",
                              "DOUBLE_MIRROR", "UNIONGROUP")]
        why += [f"GROUP {g.name} with Teq_dynamics=GLOBAL_ENERGY"
                for g in gt.groups
                if g.parms.get("teq_dynamics") == "GLOBAL_ENERGY"]
        if gt.time_dependent:
            why.append("a time-dependent Teq or PISTON vz")
        if why:
            raise NotImplementedError(
                f"{', '.join(why)} under the mesh: the JAX mesh runs such a "
                "deck as plain NGLF with constant group coefficients; not "
                f"ported to the mesh yet ({_MESH_ITEM})")

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

    def _setup_barostat(self, db, gid):
        """The Berendsen barostat of the NGLFCONSTRAINT family (beta > 0)
        and, for multi-bead molecules, the gid-keyed molecule table of
        the sharded molecular virial (JAX parallel_sim.py:266-295)."""
        sd = self.sysdef
        ip = sd.integrator_parms
        self.barostat, self._mol_gids = None, None
        self.n_molecules = sd.state.n_local
        if sd.integrator_type not in _BAROSTAT_TYPES or not ip["beta"] > 0:
            return
        sysobj = db.get(sd.cfg.system_name, "SYSTEM")
        mols = build_molecule_class(db, sysobj, sd.collection.species_names,
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
        batched bonded plan in rf_add mode beside the in-kernel exclusion
        channels, the RATTLE templates (or generic groups), and the
        chain-head gids of molecule-coherent migration."""
        sd = self.sysdef
        bt = sd.bonded
        self._bonded_plan = self._cons_templates = self._cons_tables = None
        self._hgid = self._excl_vals = None
        if bt is None:
            return
        from ..integrators.constraints import build_constraint_templates

        n = sd.state.n_local
        if bt.exclusions is not None and self.force_kind == "martini":
            wide = wide_exclusion_component(sd)
            if wide:
                raise NotImplementedError(
                    f"an exclusion component of {wide} particles exceeds "
                    "what the in-kernel exclusion channels encode; under "
                    "the mesh such a deck needs the brick "
                    "(N,K)-list engine (the JAX package's make_brick_step), "
                    f"not ported yet ({_MESH_ITEM})")
            self._excl_vals = _excl_channels(bt.exclusions, n)
        btab = bonded_tables(sd)
        if btab is not None:
            self._bonded_plan = mesh_bonded_plan(
                btab, sd.residue_instances, n, gid, self.device)
        if uses_constraints(sd):
            self._cons_templates = build_constraint_templates(
                bt.cons_atoms, bt.cons_pairs, bt.cons_dist,
                sd.residue_instances, gid)
            if self._cons_templates is None:
                self._cons_tables = constraint_gid_tables(bt, gid)
        self._hgid = chain_head_gids(gid, sd.residue_instances,
                                     bt.chain_links)

    def _check_geometry(self, L, rlist):
        """The cell engine's gate (_pick_shard_engine): every open axis
        needs bricks >= rlist, and >= 2 rlist on a 2-brick axis (an atom
        within rlist of both faces would need two ghost images).  Where
        the JAX package falls back to its (N,K)-list engine, raise."""
        for a in range(3):
            na = self.shape[a]
            span = L[a] / na
            if na > 1 and span < rlist * (2.0 if na == 2 else 1.0):
                raise NotImplementedError(
                    f"axis {a}: brick {span:.3f} too narrow for rlist "
                    f"{rlist:.3f}; the brick (N,K)-list engine the JAX "
                    "package runs then (make_brick_step) is not ported yet "
                    f"({_MESH_ITEM})")

    def _live_L(self) -> np.ndarray:
        return self.Lv.cpu().numpy().astype(np.float64)

    def _build_step_fns(self):
        """Plan the extended grid at the LIVE box and build the step."""
        sd = self.sysdef
        L = self._live_L()
        self.cplan = plan_shard_cells(
            L, self.shape, sd.rcut_max, sd.neighbor_deltaR, sd.state.n_local,
            density_safety=self._density_safety,
            plan_margin=_NPT_PLAN_MARGIN if self.barostat else 1.0)
        self.step_fn = BrickStepCells(
            self.mesh, self.plan, self.cplan, self.tables, self.coeffs,
            sd.cfg.dt, L, self._tmap, sd.random_seed, self.chunk_steps,
            coulomb=self._coulomb, force_kind=self.force_kind,
            excl=self._excl_vals is not None, bonded_plan=self._bonded_plan,
            cons_templates=self._cons_templates,
            cons_tables=self._cons_tables, mol_gids=self._mol_gids,
            barostat=self.barostat,
            has_berendsen=sd.group_table.has_berendsen)

    def _distribute(self, arrays):
        """This rank's brick of the host arrays at the live box, on the
        device."""
        buf, mask, _ = distribute_bricks(arrays, self._live_L(), self.plan)
        cap, rank = self.plan.local_cap, self.mesh.rank
        rows = slice(rank * cap, (rank + 1) * cap)
        self.fields = {k: torch.as_tensor(v[rows], device=self.device)
                       for k, v in buf.items()}
        self.mask = torch.as_tensor(mask[rows], device=self.device)
    def gather_by_gid(self, names=("r", "v")) -> dict:
        """Every rank's owned rows of the named fields (and "f") on the
        host, in the collection's original order (the pio gather
        analog: rows keyed by gid)."""
        m = self.mesh.all_gather(self.mask.to(torch.int64)).cpu().numpy()
        m = m.reshape(-1).astype(bool)
        g = self.mesh.all_gather(self.fields["gid"]).cpu().numpy()
        g = g.reshape(-1)[m]
        col = gid64(self.sysdef.collection.gid)
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
        """Forces and energy of the current state at the live box; keeps
        the molecular virial diagonal the next NPT step reads."""
        self.f, e, virial, ov = self.step_fn.first_forces(
            self.fields, self.mask, self.Lv)
        if bool(ov):
            raise RuntimeError("neighbor overflow at first energy")
        self.vird = torch.diagonal(virial).clone()
        return float(e)

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
        at its end: (new state (fields, mask, f[, vird, Lv]), scalars
        (k, 7) numpy, overflow, steps).  kind "super" runs n_super
        chunks, "chunk" one chunk (NPT: of `steps` steps), "step" one NVT
        step without migration."""
        st = self.step_fn
        npt = (self.vird, self.Lv) if self.barostat else ()
        if kind == "super":
            state, scal, ov = st.superchunk(self.fields, self.mask, self.f,
                                            self.loop, n_super, *npt)
        elif kind == "chunk" and npt:
            *state, scal, ov = st.chunk_npt(self.fields, self.mask, self.f,
                                            *npt, self.loop, steps or None)
        elif kind == "chunk":
            *state, scal, ov = st.chunk(self.fields, self.mask, self.f,
                                        self.loop)
        else:
            fields, f, scal, ov = st.step(self.fields, self.mask, self.f,
                                          self.loop)
            state, scal = (fields, self.mask, f), scal[None]
        host = torch.cat([scal.reshape(-1),
                          ov.to(scal.dtype).reshape(1)]).cpu().numpy()
        rows = host[:-1].astype(np.float64).reshape(-1, 7)
        return tuple(state), rows, bool(host[-1]), rows.shape[0]

    def run(self, n_loops: int, *, print_fn=None,
            max_steps_per_dispatch: int | None = None):
        """Chunked dispatch: ddc updateRate steps plus one migration per
        chunk; with max_steps_per_dispatch >= 2 chunks, that many chunks
        per dispatch (the superchunk).  Leftover loops take the per-step
        path (NVT) or one shorter NPT chunk.  An overflowing dispatch
        rolls back to the state before it (the box and virial diagonal
        too) and escalates: (1) host redistribute, (2) replan at the live
        box, (3) raise."""
        if self.f is None:
            self.first_energy()
        done = 0
        k = self.chunk_steps
        M = (max_steps_per_dispatch // k if max_steps_per_dispatch
             and max_steps_per_dispatch >= 2 * k else 0)
        redis_tries = 0
        while done < n_loops:
            steps = 0
            if M and done + M * k <= n_loops:
                kind = "super"
            elif done + k <= n_loops:
                kind = "chunk"
            else:
                kind = "chunk" if self.barostat else "step"
                steps = n_loops - done
            t0 = _time.perf_counter()
            state, rows, ov, steps = self._dispatch(kind, M, steps)
            seconds = _time.perf_counter() - t0
            if ov:
                if kind == "step":
                    raise RuntimeError(f"overflow at loop {self.loop}")
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
            if self.barostat:
                self.vird, self.Lv = state[3:]
            self._print_scalars(rows, print_fn, self.loop)
            self.loop += steps
            done += steps
            self.dispatch_log.append((steps, seconds))
        return self

    def redistribute(self):
        """Host-exact re-assignment of every particle to its brick at the
        live box (no replan): recovers from a migration or halo
        overflow."""
        g = self.gather_by_gid(("r", "v"))
        arrays = dict(self._host_arrays, r=g["r"], v=g["v"])
        self._distribute(arrays)
        self.f = None
        self.first_energy()

    def replan(self):
        """Replan the cell grid at the LIVE box (a barostat-compressed box
        can take a cell edge below rlist; fewer, larger cells restore the
        one-shell stencil), with 1.3x the density safety when that
        changes nothing (a larger cell capacity, as the single-device run
        loop grows it), and redistribute.  A brick narrower than rlist at
        the live box makes the decomposition itself infeasible: raise."""
        L = self._live_L()
        widths = L / np.asarray(self.shape, np.float64)
        if widths.min() < self.plan.rlist:
            raise RuntimeError(
                f"brick decomposition infeasible at the live box: narrowest "
                f"brick {widths.min():.4f} < rlist {self.plan.rlist:.4f} "
                f"(box {L}); use fewer bricks along the compressed axis")
        old = (self.cplan.ncore, self.cplan.cap)
        self._build_step_fns()
        if (self.cplan.ncore, self.cplan.cap) == old:
            self._density_safety *= 1.3
            self._build_step_fns()
        self.redistribute()
