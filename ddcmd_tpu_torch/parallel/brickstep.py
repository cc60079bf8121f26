"""Brick-mesh MD steps: what both mesh engines share, and the (N,K)-list
engine.

Counterpart of ddcmd_tpu/parallel/brickstep.py.  BrickStepBase holds the
machinery of one rank's step that does not depend on how pair forces
are found: the kicks with their per-rank thermostat noise, the RATTLE
projection of the owned constraint groups, the molecular virial, the
one all-reduce of the step's scalars, migration, the chunk -- whose
steps move the box by the deck's rule (the Berendsen lambda, box(t),
NPTGLF's zeta, NGLFNK's pistons; the integrators' own pieces) -- and the
superchunk.  Its engines supply the rebuild at a chunk's
start and the forces of a step:

  * parallel/brickstep_cells.BrickStepCells: the extended-grid cell
    kernels (TPU kernels #6 and #7), frozen halo routing per chunk;
  * BrickStepList (here): make_brick_step's engine, a per-brick (N,K)
    neighbour list in plain PyTorch (no kernel), rebuilt every step --
    wrap -> staged halo exchange (walls or Voronoi windows) -> one list
    over the local rows and their ghosts on a global CellGrid
    (nbr/celllist.build_neighbor_list) -> the force path: "martini"
    (MARTINI, and PAIR without a table with zero reaction-field
    constants) through martini_nonbond, "pairtab" (a PAIR
    TableFunction) through pair_lj, or "eam" (any form: density from
    the position halo, a second halo shipping each ghost's dF from its
    owner along the same routing, then forces with the transposed
    density term) -> the bonded terms, batched per residue type and per
    term for the rest (parallel/bonded_shard), resolved against the
    pool and their ghost-row shares reduced home.

Excluded pairs never enter a force: each row carries the gids of its
excluded partners as an (n, Emax) int64 field `exgid` (pad -1) that
migrates with it, and the list drops neighbour j of row i when gid(j)
is in row i's set; the bonded exclusion term (rf_add mode) adds back
only the reaction-field part the reference keeps.  The JAX list engine
computes excluded pairs and subtracts them (its brickstep.py:183-203).
Only local rows have list rows, so the field does not ship in the halo.

The list engine takes any dtype (f32, f64).  Its halo windows are
measured from the brick's centre with the periodic wrap (positions are
wrapped every step, so a row that crossed the seam since the last
migration still ships toward the side it lies on); on an axis of three
or more bricks every brick must be at least rlist wide (the staged
exchange reaches one brick), which the overflow flag guards under a
barostat together with the cell edge.  It takes orthorhombic boxes and a
triclinic (3, 3) h: the JAX package's engine pick sends every triclinic
deck here (its parallel_sim.py:647-683).  Under an h the halo windows are
fractional with perpendicular-span depths (parallel/brick.geom_frac),
the pair terms and both EAM passes take the full vector's minimum image,
brick and cell widths are perpendicular spans, and the Berendsen move is
h' = diag(lam) h by rows (the JAX package's brickstep.py:26-48,
102-160, 357-415).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import Box, geom_volume, inv3x3, nearest_image, perp_spans
from ..core.energy import kinetic_terms
from ..core.groups import kick_noise, union_callsite, velocity_update
from ..integrators.nglf import (barostat_lambda, box_time_map, device_hooks,
                                kick_context)
from ..integrators.nptglf import nptglf_close, nptglf_drift, nptglf_open
from ..nbr.celllist import build_neighbor_list
from ..potentials.bonded import bonded_eval
from ..potentials.bonded_batch import batched_bonded_eval
from ..potentials.eam import _embedding, _pair_eval
from ..potentials.martini import martini_nonbond
from ..potentials.pair import pair_lj
from .bonded_shard import resolve_batched, resolve_constraints, resolve_terms
from .brick import (BrickPlan, halo_exchange_3d, halo_reduce_3d,
                    halo_refresh_3d, migrate_3d)
from .shard_cells import walls_span_minmax

# thermostat noise callsite of the mesh step (the single-device NGLF
# step draws callsite 0); the rank rides in the bits above it
_NOISE_CALLSITE_MESH = 1
# columns of a step's scalar row: e_pot, rk, tr virial, the molecular
# virial diagonal (3), volume, then the mesh-wide virial (9), row-major
SCALAR_COLS = 16


def _e_pot(pe):
    """The rows' potential energy summed in f64 and rounded once to their
    dtype: an f32 sum strays from the exact one by a few units in its
    last place, and a periodic replica's energy would stray as far from
    the sum of its copies'."""
    return pe.sum(dtype=torch.float64).to(pe.dtype)


class BrickStepBase:
    """One rank's mesh step, less its engine.  fields: dict of
    (local_cap, ...) tensors r, v, q, mass, species, group, gid (int64),
    and with a covalent topology hgid (int64, the molecule head's gid);
    mask: (local_cap,) bool; f: (local_cap, 3).

    fields also carry r0, the position at the row's last migration or
    distribution, which the drift guard measures from; a step writes pe,
    each row's potential energy after its force call (the per-group
    files and the gathered view read it).

    Optional tables (host-built by run/parallel_sim): bonded_plan and
    bonded_left, mesh_bonded_plan's batched plan and gid-keyed leftover;
    cons_templates, the (plan, project) of build_constraint_templates,
    or cons_tables, the constraint_gid_tables dict of a topology that is
    not template-regular; mol_gids, molecule_gid_tables' (M, A) gids;
    the barostat dict of the single-device Simulation; has_berendsen:
    some group is BERENDSEN (its temperature is summed over the mesh).
    skin: the deck's neighbour skin deltaR (the drift guard's bound).

    The integrator's step: kind "nglf" (the NGLF family, the NVE
    variants by their coefficients), "nptglf" with nptglf = {n_global,
    Gamma, Peq}, or "nglfnk" with piston, an integrators/nglfnk.PistonNK;
    hooks, the hook groups (integrators/nglf.kick_context), and
    union_draws, the UNIONGROUP members' draws (GroupTable's), of the
    NGLF family; extforce, the EXTFORCE forces by group or None;
    clock(loop) -> the run's time at a loop (the host's clock, which
    the hooks read).

    The drift guard (the per-step dispatch of step() and a chunk longer
    than chunk_steps, where rows go longer between migrations than the
    deck's updateRate promises): a row that moved half the skin or more
    since its last migration flags an overflow, as the single-device
    run's stale test does (2 max_disp >= deltaR), so the host rolls
    the dispatch back and redistributes instead of losing its pairs.
    An engine says where it needs it (drift_in_step, drift_in_chunk)
    and adds its own check of a rebuild between migrations
    (_rebuild_guard).

    An engine defines _rebuild(fields, mask, Lv) -> (fields, rb,
    overflow), _forces(r_local, rb, Lv) -> (f, pe, virial, overflow)
    and _narrow(Lv) (the NPT shrink guard); rb["pe_self"], when set, is
    each local row's self energy, added to its pe.  Every
    method returns new tensors and leaves its inputs untouched, so a
    caller can roll back by keeping references."""

    def __init__(self, mesh, plan: BrickPlan, tables, coeffs, dt: float,
                 box_lengths, species_lj_type, seed: int, chunk_steps: int,
                 *, force_kind: str, skin: float, bonded_plan=None,
                 bonded_left=None, cons_templates=None, cons_tables=None,
                 mol_gids=None, barostat=None, has_berendsen=False,
                 dtype=torch.float32, kind="nglf", nptglf=None, piston=None,
                 hooks=(), union_draws=(), extforce=None, clock=None):
        dev = mesh.device
        self.mesh, self.plan = mesh, plan
        self.tables, self.coeffs = tables, coeffs
        self.dt, self.seed, self.chunk_steps = dt, seed, chunk_steps
        self.force_kind, self.dtype = force_kind, dtype
        self.bonded_plan, self.bonded_left = bonded_plan, bonded_left
        self.barostat, self.has_berendsen = barostat, has_berendsen
        self.skin = skin
        self.kind, self.npt, self.piston = kind, nptglf, piston
        self._step_body = {"nglf": self._step_nglf,
                           "nptglf": self._step_nptglf,
                           "nglfnk": self._step_nglfnk}[kind]
        self.clock = clock
        self.hooks = device_hooks(hooks, dtype, dev)
        self.union_draws = union_draws
        self.extforce = (None if extforce is None else
                         torch.as_tensor(extforce, dtype=dtype, device=dev))
        self._pbc_ones = torch.ones(3, dtype=dtype, device=dev)
        # where the drift guard holds: the per-step dispatch, a long chunk
        self.drift_in_step = self.drift_in_chunk = True
        # wrap the positions after each drift (the list engine, as
        # Simulation's list engine does; the cells engine keeps them
        # unwrapped between rebuilds, as Simulation's kernel path does)
        self.wrap_drift = False
        self.Lv = torch.as_tensor(box_lengths, dtype=dtype, device=dev)
        self.tmap = torch.as_tensor(species_lj_type, dtype=torch.int64,
                                    device=dev)
        self.cons_templates = None
        if cons_templates is not None:
            tplan, project = cons_templates
            types = [dict(tp, gids=tp["gids"].to(dev),
                          d2=tp["d2"].to(device=dev, dtype=dtype))
                     for tp in tplan["types"]]
            self.cons_templates = (dict(types=types), project)
        self.cons_tables = None
        if cons_tables is not None:
            from ..integrators.constraints import make_constraint_project

            gids = cons_tables["cons_gids"].to(dev)
            project = make_constraint_project(
                cons_tables["cons_pairs"], cons_tables["cons_dist"],
                dtype, gids.shape[1], device=dev)
            self.cons_tables = (gids, project)
        self.mol_gids = None if mol_gids is None else mol_gids.to(dev)
        self._generator = torch.Generator(device=dev)
        self._callsite = _NOISE_CALLSITE_MESH | (mesh.rank << 8)

    # -- the owned groups, resolved once per rebuild ------------------------

    def _resolve_local(self, fields, mask, rb):
        """Constraint groups and molecules this rank owns (wholly local
        by molecule coherence) into rb; inverse masses and molecule
        masses are static within a chunk, so they are gathered here
        once, as is rb["mass"], the rows' masses with 1 on the rows this
        rank does not own (mass 0 there), as the single-device state
        pads: every per-row term of a kick and every slice sum stays
        finite."""
        rb.update(cons_bat=None, cons=None, mol=None,
                  mass=torch.where(mask, fields["mass"],
                                   torch.ones_like(fields["mass"])))
        n_l = mask.shape[0]
        if self.cons_templates is not None or self.cons_tables is not None \
                or self.mol_gids is not None:
            rmass = torch.where(mask, 1.0 / fields["mass"].clamp(min=1e-30),
                                torch.zeros_like(fields["mass"]))
        if self.cons_templates is not None:
            tplan, _ = self.cons_templates
            rb["cons_bat"] = []
            for tp, (rows, w) in zip(tplan["types"], resolve_batched(
                    tplan, fields["gid"], mask, n_l)):
                rm2 = rmass[rows.clamp(max=n_l - 1)]
                rb["cons_bat"].append(
                    (rows, w.to(rmass.dtype),
                     rm2.reshape(tp["M"], tp["A"]).T))
        if self.cons_tables is not None:
            atoms, gw = resolve_constraints(self.cons_tables[0],
                                            fields["gid"], mask, n_l)
            rb["cons"] = (atoms, gw.to(rmass.dtype),
                          torch.cat([rmass, rmass.new_zeros(1)]))
        if self.mol_gids is not None:
            atoms, gw = resolve_constraints(self.mol_gids, fields["gid"],
                                            mask, n_l)
            dt_ = fields["mass"].dtype
            am = (atoms < n_l).to(dt_)
            mm = torch.cat([fields["mass"], fields["mass"].new_zeros(1)]
                           )[atoms] * am
            rb["mol"] = (atoms, gw.to(dt_), mm, am,
                         mm.sum(1, keepdim=True).clamp(min=1e-30))

    def _resolve_bonded(self, pool_gid, pool_mask, n_l):
        """(batched, per-term) resolutions of the bonded tables against a
        pool (resolve_batched, resolve_terms); None for a table the deck
        does not have."""
        return (None if self.bonded_plan is None else resolve_batched(
                    self.bonded_plan, pool_gid, pool_mask, n_l),
                None if self.bonded_left is None else resolve_terms(
                    self.bonded_left, pool_gid, pool_mask, n_l))

    def _bonded_pool(self, r_pool, Lv, bat, left):
        """(f, pe, virial) on the pool rows of the bonded terms this rank
        owns, the batched types (resolved `bat`) and the per-term
        leftover (resolved `left`); None without bonded terms."""
        n_pool, dt_ = r_pool.shape[0], r_pool.dtype
        out = None
        if bat is not None:
            fb, _, vb, peb = batched_bonded_eval(
                r_pool, Lv, self.bonded_plan, n_pool, dt_, resolved=bat)
            out = (fb, peb, vb)
        if left is not None:
            fl, _, vl, pel = bonded_eval(r_pool, Lv, left, n_pool, dt_)
            out = (fl, pel, vl) if out is None else (
                out[0] + fl, out[1] + pel, out[2] + vl)
        return out

    # -- constraints and the molecular virial -------------------------------

    def _rattle(self, r, v, mode_front: bool, Lv, rb):
        """Velocity projection of the owned constraint groups (front: the
        post-drift lengths, back: r . v = 0) at the live box."""
        if rb["cons_bat"] is not None:
            tplan, project = self.cons_templates
            n_l = v.shape[0]
            # disowned instances write back the velocities they read, and
            # missing rows (the sentinel n_l) land in a dropped tail row
            v_ext = torch.cat([v, v.new_zeros((1, 3))])
            for tp, (rows, w, rm2) in zip(tplan["types"], rb["cons_bat"]):
                M, A = tp["M"], tp["A"]
                rcl = rows.clamp(max=n_l - 1)
                rb3 = r[rcl].reshape(M, A, 3).permute(2, 1, 0)
                vb3 = v[rcl].reshape(M, A, 3).permute(2, 1, 0)
                vb3 = project(rb3, vb3, rm2, w, tp["d2"], tp["li"], tp["lj"],
                              self.dt, mode_front, Lv)
                v_ext[rows] = vb3.permute(2, 1, 0).reshape(M * A, 3)
            return v_ext[:n_l]
        if rb["cons"] is not None:
            atoms, gw, rm_ext = rb["cons"]
            n_l = v.shape[0]
            at = atoms.clamp(max=n_l)
            zero = v.new_zeros((1, 3))
            v_ext = torch.cat([v, zero])
            v_new = self.cons_tables[1](torch.cat([r, zero]), v_ext, rm_ext,
                                        at, gw, self.dt, mode_front, L=Lv)
            v_ext[at.reshape(-1)] = v_new.reshape(-1, 3)
            return v_ext[:n_l]
        return v

    def _mol_corr(self, r, f, Lv, rb):
        """Diagonal molecular-virial correction sum_i d_i f_i over the owned
        multi-bead molecules, d the bead's offset from its molecule's
        centre of mass (molecularPressure.c:22-67)."""
        atoms, gw, mm, am, Msum = rb["mol"]
        zero = r.new_zeros((1, 3))
        rm = torch.cat([r, zero])[atoms]
        fm = torch.cat([f, zero])[atoms]
        d = nearest_image(rm - rm[:, :1], Lv)
        com = (mm[:, :, None] * d).sum(1, keepdim=True) / Msum[:, :, None]
        d = (d - com) * am[:, :, None]
        return torch.einsum("m,mia,mia->a", gw, d, fm)

    def _psum_parts(self, *parts):
        """Each tensor of `parts` summed over the mesh, in one all-reduce
        of their concatenation (the dtype of the first)."""
        dt_ = parts[0].dtype
        flat = self.mesh.psum(torch.cat([p.to(dt_).reshape(-1)
                                         for p in parts]))
        out, i = [], 0
        for p in parts:
            out.append(flat[i:i + p.numel()].reshape(p.shape))
            i += p.numel()
        return out

    def _reduce(self, e_pot, rk, virial, corr, ov):
        """(e_pot, rk, virial, molecular-virial correction (3,), overflow)
        summed over the mesh in one all-reduce; the overflow flag rides
        as a count (> 0 anywhere)."""
        dev, dt_ = virial.device, virial.dtype
        e_pot, rk, virial, corr, ov = self._psum_parts(
            torch.as_tensor(e_pot, dtype=dt_, device=dev).reshape(1),
            torch.as_tensor(rk, dtype=dt_, device=dev).reshape(1), virial,
            corr, ov.reshape(1))
        return e_pot[0], rk[0], virial, corr, ov[0] > 0

    # -- the drift guard --------------------------------------------------

    def _drift_guard(self, fields, mask, Lv):
        """True when an owned row moved half the skin or more since its
        last migration (its r0 field), at box Lv: the bound within which
        both engines find every pair of a row that left its brick."""
        d = nearest_image(fields["r"] - fields["r0"], Lv)
        d2 = torch.where(mask, (d * d).sum(1), torch.zeros_like(d[:, 0]))
        return 4.0 * d2.max() >= self.skin * self.skin

    def _rebuild_guard(self, fields, mask, Lv):
        """The engine's check of a rebuild made between migrations (the
        per-step dispatch): none here."""
        return torch.zeros((), dtype=torch.bool, device=mask.device)

    # -- per-step pieces --------------------------------------------------

    def _noise(self, step: int, shape, dtype):
        """The step's two kick draws (2, *shape) at this rank's callsite
        and, with UNIONGROUPs, each member's (2, members, *shape) at its
        union_callsite in the bits above the rank's, or None."""
        shape = (2,) + tuple(shape)
        noise = kick_noise(self._generator, self.seed, step, self._callsite,
                           shape, dtype=dtype)
        if not self.union_draws:
            return noise, None
        return noise, torch.stack([
            kick_noise(self._generator, self.seed, step,
                       self._callsite | (union_callsite(g, j) << 32),
                       shape, dtype=dtype)
            for g, j in self.union_draws], dim=1)

    def _box(self, Lv) -> Box:
        """The live box geometry Lv ((3,) lengths or the (3, 3) h) as a
        fully periodic Box."""
        ortho = Lv.dim() == 1
        return Box(h=torch.diag(Lv) if ortho else Lv, pbc=7,
                   pbc_mask=self._pbc_ones, ortho=ortho)

    def _hooks(self, r, Lv, step: int, draws, k: int):
        """velocity_update's shear_ctx of kick k of global step `step` (0
        the front kick, at the step's start time; 1 the back kick, at its
        end), None without hook groups."""
        if not self.hooks:
            return None
        return kick_context(r, self._box(Lv), self.clock(step + k),
                            self.hooks, None if draws is None else draws[k])

    def _force_call(self, fields, mask, rb, Lv):
        """The engine's forces at box Lv with its self energy and the
        EXTFORCE groups' constant forces (potential -F.r a row, no
        virial; run/forces._extforce_term): (f, pe, virial, overflow)."""
        f, pe, virial, ov = self._forces(fields["r"], rb, Lv)
        pe = self._with_self(pe, rb)
        if self.extforce is not None:
            fe = self.extforce[fields["group"]] * mask.to(f.dtype)[:, None]
            f = f + fe
            pe = pe - (fe * fields["r"]).sum(dim=1)
        return f, pe, virial, ov

    @staticmethod
    def _geom(h, Lv):
        """h in the live box's form: its diagonal for (3,) lengths."""
        return torch.diagonal(h) if Lv.dim() == 1 else h

    @staticmethod
    def _row(e_pot, rk, virial, vd, Lv):
        """The step's scalar row (SCALAR_COLS), one stack."""
        return torch.stack([e_pot, rk, torch.trace(virial), vd[0], vd[1],
                            vd[2], geom_volume(Lv),
                            *virial.reshape(9).unbind()])

    # _step_body, bound to the kind's step in __init__:
    # (fields, mask, f_prev, step, rb, ov, dyn, guard=False, box_lam=None)
    # -> one step at global step `step` on the rebuilt tables `rb`, from
    # the box and barostat state `dyn` (the chunk's carry: Lv, vird,
    # zeta, bdot, ptens); ov is this rank's overflow so far, reduced with
    # the step's scalars, and with `guard` the drift guard's flag;
    # box_lam: this step's prescribed box(t) (E, M, h_ref) or None.
    # Returns (fields, f, dyn, scalars (SCALAR_COLS,), overflow
    # mesh-wide); scalars [e_pot, rk, tr virial, molecular virial
    # diagonal (3), volume, virial (9)]; the pe field takes the step's
    # per-row potential energy.

    def _step_nglf(self, fields, mask, f_prev, step, rb, ov, dyn, guard=False,
                   box_lam=None):
        """The NGLF family (integrators/nglf.make_nglf_step's order): the
        Berendsen rescale from the last step's molecular virial diagonal,
        the front kick with the hook groups, RATTLE, the drift, the
        prescribed box(t) mapping the rows (r0 too), the wrap, forces, the
        back kick, RATTLE; one all-reduce."""
        Lv = dyn["Lv"]
        if self.barostat is not None:
            lam = barostat_lambda(dyn["vird"], geom_volume(Lv), self.barostat,
                                  self.dt)
            # h' = diag(lam) h: a (3, 3) h scales by rows (the JAX
            # package's brickstep.py:397-399)
            Lv = lam[:, None] * Lv if Lv.dim() == 2 else Lv * lam
            ov = ov | self._narrow(Lv)
            fields = dict(fields, r=fields["r"] * lam, r0=fields["r0"] * lam)
        noise, draws = self._noise(step, fields["r"].shape,
                                   fields["v"].dtype)
        half = 0.5 * self.dt
        mass = rb["mass"]
        # a BERENDSEN group's temperature and a SHEAR slice's statistics
        # sum over every rank
        v = velocity_update("front", fields["v"], f_prev, mass,
                            fields["group"], self.coeffs, half, noise[0], mask,
                            self.has_berendsen,
                            self._hooks(fields["r"], Lv, step, draws, 0),
                            group_sum=self.mesh.psum)
        v = self._rattle(fields["r"], v, True, Lv, rb)
        r = fields["r"] + self.dt * v
        r0 = fields["r0"]
        if box_lam is not None:
            h = torch.diag(Lv) if Lv.dim() == 1 else Lv
            h_new, A = box_time_map(h, box_lam)
            Lv = self._geom(h_new, Lv)
            r, r0 = r @ A.T, r0 @ A.T
            ov = ov | self._narrow(Lv)
        fields = dict(fields, r=nearest_image(r, Lv) if self.wrap_drift
                      else r, v=v, r0=r0)

        f, pe, virial, ov_c = self._force_call(fields, mask, rb, Lv)
        e_pot = _e_pot(pe)
        if guard:
            ov_c = ov_c | self._drift_guard(fields, mask, Lv)

        v = velocity_update("back", fields["v"], f, mass,
                            fields["group"], self.coeffs, half, noise[1], mask,
                            False,
                            self._hooks(fields["r"], Lv, step, draws, 1),
                            group_sum=self.mesh.psum)
        v = self._rattle(fields["r"], v, False, Lv, rb)
        fields = dict(fields, v=v, pe=pe)
        fmask = mask.to(v.dtype)
        rk = 0.5 * ((fields["mass"] * fmask)[:, None] * v * v).sum()
        corr = (self._mol_corr(fields["r"], f, Lv, rb) if rb["mol"] is not None
                else virial.new_zeros(3))
        e_pot, rk, virial, corr, ov = self._reduce(e_pot, rk, virial, corr,
                                                   ov | ov_c)
        vd = torch.diagonal(virial) - corr
        return (fields, f, dict(dyn, Lv=Lv, vird=vd),
                self._row(e_pot, rk, virial, vd, Lv), ov)

    def _step_nptglf(self, fields, mask, f_prev, step, rb, ov, dyn,
                     guard=False, box_lam=None):
        """NPTGLF (integrators/nptglf.py's pieces): zeta from the last
        step's mesh-wide pressure tensor (dyn["ptens"]), the drag, the
        front kick, the breathing drift and the isotropic box move (r0
        scaled with it), forces, the back kick, then one all-reduce of
        the energy, the virial and the kinetic tensor for the
        self-consistent rescale.  No hooks and no box(t), as the
        single-device step."""
        p = self.npt
        Lv = dyn["Lv"]
        vol = geom_volume(Lv)
        zeta, vol_atom, drag = nptglf_open(dyn["zeta"], dyn["ptens"], vol,
                                           p["n_global"], self.dt,
                                           p["Gamma"], p["Peq"])
        noise, _ = self._noise(step, fields["r"].shape, fields["v"].dtype)
        half = 0.5 * self.dt
        mass = rb["mass"]
        v = velocity_update("front", fields["v"] * drag, f_prev,
                            mass, fields["group"], self.coeffs, half,
                            noise[0], mask, self.has_berendsen,
                            group_sum=self.mesh.psum)
        r, lam, vol_atom = nptglf_drift(fields["r"], v, zeta, vol_atom, vol,
                                        p["n_global"], self.dt, p["Gamma"])
        Lv = lam[:, None] * Lv if Lv.dim() == 2 else Lv * lam
        ov = ov | self._narrow(Lv)
        fields = dict(fields, r=nearest_image(r, Lv) if self.wrap_drift
                      else r, v=v, r0=fields["r0"] * lam)

        f, pe, virial, ov_c = self._force_call(fields, mask, rb, Lv)
        if guard:
            ov_c = ov_c | self._drift_guard(fields, mask, Lv)
        v = velocity_update("back", fields["v"], f, mass,
                            fields["group"], self.coeffs, half, noise[1], mask)
        _, tion = kinetic_terms(v, mass, mask.to(v.dtype))
        e_pot, virial, tion, ovs = self._psum_parts(
            _e_pot(pe).reshape(1), virial, tion, (ov | ov_c).reshape(1))
        rk = 0.5 * torch.trace(tion)
        zeta, fac = nptglf_close(zeta, virial, tion, rk, geom_volume(Lv),
                                 vol_atom, self.dt, p["Gamma"], p["Peq"])
        fields = dict(fields, v=v * fac, pe=pe)
        tion = tion * fac * fac
        dyn = dict(dyn, Lv=Lv, zeta=zeta, ptens=virial + tion)
        return (fields, f, dyn, self._row(e_pot[0], rk * fac * fac, virial,
                                          torch.diagonal(virial), Lv),
                ovs[0] > 0)

    def _step_nglfnk(self, fields, mask, f_prev, step, rb, ov, dyn,
                     guard=False, box_lam=None):
        """NGLFNK (integrators/nglfnk.PistonNK's pieces): the front
        half-kick and the piston's first half-step from the last step's
        mesh-wide pressure tensor, the drift of rows and box (r0 mapped
        with the box), the wrap, forces, one all-reduce of the energy,
        the virial and the half-step kinetic tensor, the second half-step
        and the back half-kick, one all-reduce of the kinetic tensor.
        The group coefficients play no part."""
        pis = self.piston
        Lv = dyn["Lv"]
        h = torch.diag(Lv) if Lv.dim() == 1 else Lv
        noise, _ = self._noise(step, fields["r"].shape, fields["v"].dtype)
        fmask = mask.to(fields["v"].dtype)
        mass = rb["mass"]
        carry, r, h_new = pis.front(fields["r"], fields["v"], f_prev, mass,
                                    fmask, h, dyn["bdot"], dyn["ptens"],
                                    noise[0])
        Lv_new = self._geom(h_new, Lv)
        ov = ov | self._narrow(Lv_new)
        if self.wrap_drift:
            r = nearest_image(r, Lv_new)
            carry = pis.wrapped(carry, r)
        fields = dict(fields, r=r, r0=fields["r0"] @ (h_new @ inv3x3(h)).T)

        f, pe, virial, ov_c = self._force_call(fields, mask, rb, Lv_new)
        if guard:
            ov_c = ov_c | self._drift_guard(fields, mask, Lv_new)
        _, tion_h = kinetic_terms(pis.half_velocity(carry), mass, fmask)
        e_pot, virial, tion_h, ovs = self._psum_parts(
            _e_pot(pe).reshape(1), virial, tion_h, (ov | ov_c).reshape(1))
        V = geom_volume(Lv_new)
        v, dLdt = pis.back(carry, f, virial + tion_h, V, noise[1])
        _, tion = kinetic_terms(v, mass, fmask)
        tion = self.mesh.psum(tion)
        fields = dict(fields, v=v, pe=pe)
        dyn = dict(dyn, Lv=Lv_new, bdot=dLdt, ptens=virial + tion)
        return (fields, f, dyn, self._row(e_pot[0], 0.5 * torch.trace(tion),
                                          virial, torch.diagonal(virial),
                                          Lv_new), ovs[0] > 0)

    @staticmethod
    def _with_self(pe, rb):
        """The local rows' pe with the engine's self energy, when it has
        one (rb["pe_self"])."""
        return pe if rb.get("pe_self") is None else pe + rb["pe_self"]

    # -- entry points -----------------------------------------------------

    def first_forces(self, fields, mask, Lv=None):
        """(f, e_pot, virial, overflow, pe) of the current state at box Lv
        (the deck's box by default): e_pot, the virial and the overflow
        mesh-wide, the virial's diagonal carrying the molecular
        correction, as the barostat reads it; pe the local rows'
        potential energies."""
        Lv = self.Lv if Lv is None else Lv
        fields, rb, ov_r = self._rebuild(fields, mask, Lv)
        f, pe, virial, ov_c = self._force_call(fields, mask, rb, Lv)
        e_pot = _e_pot(pe)
        corr = (self._mol_corr(fields["r"], f, Lv, rb) if rb["mol"] is not None
                else virial.new_zeros(3))
        e_pot, _, virial, corr, ov = self._reduce(e_pot, 0.0, virial, corr,
                                                  ov_r | ov_c)
        return f, e_pot, virial - torch.diag(corr), ov, pe

    def step(self, fields, mask, f_prev, step: int):
        """One step of a fixed box (the deck's) on a freshly rebuilt table,
        no migration, under the drift and rebuild guards (the per-step
        dispatch, rows away from their last migration for longer than a
        chunk): (fields, f, scalars (SCALAR_COLS,), overflow)."""
        fields, rb, ov_r = self._rebuild(fields, mask, self.Lv)
        ov_r = ov_r | self._rebuild_guard(fields, mask, self.Lv)
        fields, f, _, scal, ov = self._step_body(
            fields, mask, f_prev, step, rb, ov_r, dict(Lv=self.Lv),
            guard=self.drift_in_step)
        return fields, f, scal, ov

    def migrate(self, fields, mask, f, Lv=None):
        """Staged 1-hop migration at box Lv, forces travelling with their
        rows, each row's r0 set to its position: (fields, mask, f,
        overflow mesh-wide)."""
        fields = dict(fields, r0=fields["r"])
        packed, new_mask, ov = migrate_3d(
            dict(fields, f=f), mask, self.Lv if Lv is None else Lv,
            self.plan, self.mesh)
        f_new = packed.pop("f")
        ov = self.mesh.psum(ov.to(torch.float32).reshape(1))[0] > 0
        return packed, new_mask, f_new, ov

    def chunk(self, fields, mask, f_prev, dyn, step0: int,
              steps: int | None = None, box_lam=None):
        """Rebuild at dyn's box, `steps` (chunk_steps by default) steps at
        global steps step0 .. step0+steps-1, then migrate at the live box.
        Each step moves the box by the deck's rule (the Berendsen lambda,
        box(t) -- box_lam = (E, M, h_ref) with E[i], M[i] step i's
        factors --, NPTGLF's zeta or NGLFNK's pistons) inside _step_body,
        carrying dyn ({Lv, vird, zeta, bdot, ptens}) from step to step;
        the engine's guard flags a brick too narrow for its halo, and a
        chunk longer than chunk_steps runs under the drift guard.
        Returns (fields, mask, f, dyn, scalars (steps, SCALAR_COLS),
        overflow)."""
        steps = self.chunk_steps if steps is None else steps
        guard = steps > self.chunk_steps and self.drift_in_chunk
        fields, rb, ov = self._rebuild(fields, mask, dyn["Lv"])
        f, rows = f_prev, []
        for i in range(steps):
            lam = None if box_lam is None else (box_lam[0][i], box_lam[1][i],
                                                box_lam[2])
            fields, f, dyn, scal, ov = self._step_body(
                fields, mask, f, step0 + i, rb, ov, dyn, guard, lam)
            rows.append(scal)
        fields, mask, f, ov_m = self.migrate(fields, mask, f, dyn["Lv"])
        return fields, mask, f, dyn, torch.stack(rows), ov | ov_m

    def superchunk(self, fields, mask, f_prev, dyn, step0: int, n_super: int,
                   steps: int | None = None, box_lam=None):
        """n_super chunks of `steps` (chunk_steps by default) steps in one
        dispatch with no host read, carrying dyn; box_lam spans the whole
        dispatch (chunk j takes its rows j*steps ...).  Returns ((fields,
        mask, f, dyn), scalars (n_super*steps, SCALAR_COLS), overflow).
        After an overflow the later chunks still run, on state the caller
        discards: the JAX superchunk freezes instead, and both hand back
        a flagged dispatch that the host rolls back whole."""
        k = self.chunk_steps if steps is None else steps
        ov = torch.zeros((), dtype=torch.bool, device=mask.device)
        state = (fields, mask, f_prev, dyn)
        rows = []
        for j in range(n_super):
            lam = None if box_lam is None else (
                box_lam[0][j * k:(j + 1) * k], box_lam[1][j * k:(j + 1) * k],
                box_lam[2])
            *state, scal, ov_j = self.chunk(*state, step0 + j * k, k, lam)
            rows.append(scal)
            ov = ov | ov_j
        return tuple(state), torch.cat(rows), ov


def exclusion_gids(exclusions, gid, n: int):
    """(n, Emax) int64: the gids of each row's excluded partners (both
    directions of each pair), padded with -1; None without exclusions.
    The list engine's per-row exclusion field."""
    ex = np.asarray(exclusions, np.int64).reshape(-1, 2)
    if len(ex) == 0:
        return None
    gid = np.asarray(gid, np.int64)
    a = np.concatenate([ex[:, 0], ex[:, 1]])
    b = np.concatenate([ex[:, 1], ex[:, 0]])
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    cnt = np.bincount(a, minlength=n)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    slot = np.arange(len(a)) - start[a]
    out = np.full((n, int(cnt.max())), -1, np.int64)
    out[a, slot] = gid[b]
    return out


class BrickStepList(BrickStepBase):
    """The mesh step of one rank on the (N,K)-list engine (the JAX
    package's make_brick_step).  `grid` is the global CellGrid the pool
    of local rows and ghosts is binned into; `tables` the force path's
    (martini_device_tables, or for a PAIR deck without a table
    pair_device_tables, whose reaction-field constants are zero, for
    "martini"; pair_device_tables of a TableFunction for "pairtab";
    eam_device_tables for "eam"), in `dtype`.  With `excl`
    the fields carry exgid (exclusion_gids)."""

    def __init__(self, mesh, plan: BrickPlan, grid, tables, coeffs,
                 dt: float, box_lengths, species_lj_type, seed: int,
                 chunk_steps: int, *, force_kind: str = "martini",
                 excl: bool = False, **kw):
        if force_kind not in ("martini", "pairtab", "eam"):
            raise ValueError(force_kind)
        if force_kind != "martini" and (excl or kw.get("bonded_plan")
                                        is not None
                                        or kw.get("bonded_left") is not None):
            raise ValueError(f"{force_kind} decks carry no exclusions or "
                             "bonded terms")
        super().__init__(mesh, plan, tables, coeffs, dt, box_lengths,
                         species_lj_type, seed, chunk_steps,
                         force_kind=force_kind, **kw)
        self.grid, self.excl = grid, excl
        # the list is rebuilt every step: only halo windows (an axis of
        # two or more bricks) need the rows near their bricks
        self.drift_in_step = self.drift_in_chunk = any(
            n > 1 for n in plan.shape)
        self.wrap_drift = True
        dev = mesh.device
        self._ncells = torch.tensor(grid.ncells, dtype=self.dtype,
                                    device=dev)
        # axes of 3+ bricks: the staged exchange reaches one brick, so
        # each must stay >= rlist (the NPT shrink guard)
        frac = walls_span_minmax(plan.walls, plan.shape)[0]
        self._reach_frac = torch.tensor(
            [frac[a] if plan.shape[a] > 2 else 0.0 for a in range(3)],
            dtype=self.dtype, device=dev)
        self.halo_keys = ("species",) + (
            ("q",) if force_kind == "martini" else ()) + (
            ("gid",) if excl or self.bonded_plan is not None
            or self.bonded_left is not None else ())

    def _rebuild(self, fields, mask, Lv):
        """Wrap, keep the static local fields the per-step halo ships, and
        resolve the owned constraint groups and molecules."""
        fields = dict(fields, r=nearest_image(fields["r"], Lv))
        rb = dict(static={k: fields[k] for k in self.halo_keys}, mask=mask,
                  exgid=fields.get("exgid"))
        self._resolve_local(fields, mask, rb)
        zero = torch.zeros((), dtype=torch.bool, device=mask.device)
        return fields, rb, zero

    def _narrow(self, Lv):
        return torch.any((self._reach_frac > 0)
                         & (self._reach_frac * perp_spans(Lv)
                            < self.plan.rlist))

    @staticmethod
    def _drop_excluded(nbr, pool_gid, pool_mask, exgid):
        """The local rows' (n_l, K) list with neighbour j of row i set to
        the sentinel where gid(j) is among row i's excluded partners."""
        sentinel = pool_gid.shape[0]
        g = torch.where(pool_mask, pool_gid, torch.full_like(pool_gid, -2))
        g = torch.cat([g, g.new_full((1,), -3)])[nbr]        # (n_l, K)
        hit = torch.any(g[:, :, None] == exgid[:, None, :], dim=-1)
        return torch.where(hit, torch.full_like(nbr, sentinel), nbr)

    def _pool_list(self, r_local, rb, Lv):
        """The staged halo of the wrapped local rows and the local rows'
        (n_l, K) list over the pool, excluded partners dropped: (pool
        fields, pool mask, routing, list, overflow)."""
        mask = rb["mask"]
        loc = dict(rb["static"], r=nearest_image(r_local, Lv))
        ghosts, gmask, ov, routing = halo_exchange_3d(
            loc, mask, Lv, self.plan, self.mesh, centred=True)
        pool = {k: torch.cat([loc[k], ghosts[k]]) for k in loc}
        pool_mask = torch.cat([mask, gmask])
        dt_ = pool["r"].dtype
        row_mask = torch.cat([mask, torch.zeros_like(gmask)]).to(dt_)
        nbr, _, ov_n = build_neighbor_list(pool["r"], pool_mask.to(dt_), Lv,
                                           self.grid, row_mask=row_mask,
                                           n_rows=mask.shape[0])
        if self.excl:
            nbr = self._drop_excluded(nbr, pool["gid"], pool_mask,
                                      rb["exgid"])
        return pool, pool_mask, routing, nbr, ov | ov_n

    def neighbor_list(self, fields, mask, Lv=None):
        """The list the next force call builds from this state (at box Lv,
        the deck's box by default): (local rows' list (n_l, K) into the
        pool, sentinel n_pool; pool gids or None; pool mask; overflow)."""
        Lv = self.Lv if Lv is None else Lv
        fields, rb, _ = self._rebuild(fields, mask, Lv)
        pool, pool_mask, _, nbr, ov = self._pool_list(fields["r"], rb, Lv)
        return nbr, pool.get("gid"), pool_mask, ov

    def _forces(self, r_local, rb, Lv):
        """Halo, list and forces of the local rows at box Lv: (f (n_loc,
        3), pe (n_loc,), this rank's virial share (3, 3), overflow: a
        halo or list overflow, or a cell edge below rlist)."""
        mask = rb["mask"]
        n_l = mask.shape[0]
        pool, pool_mask, routing, nbr, ov = self._pool_list(r_local, rb, Lv)
        r_pool = pool["r"]
        fmask = mask.to(r_pool.dtype)
        if self.force_kind == "martini":
            f, _, virial, pe, _ = martini_nonbond(
                r_pool, pool["q"], self.tmap[pool["species"]], fmask, nbr, Lv,
                self.tables, n_rows=n_l)
        elif self.force_kind == "pairtab":
            f, _, virial, pe = pair_lj(r_pool, pool["species"], fmask, nbr,
                                       Lv, self.tables, n_rows=n_l)
        else:
            f, virial, pe = self._eam(r_pool, pool["species"], fmask, nbr, Lv,
                                      routing)
        bond = None
        if "gid" in pool:
            bond = self._bonded_pool(r_pool, Lv, *self._resolve_bonded(
                pool["gid"], pool_mask, n_l))
        if bond is not None:
            fb, peb, vb = bond
            red = halo_reduce_3d(torch.cat([fb, peb[:, None]], dim=1),
                                 routing, self.plan, n_l, self.mesh)
            f, pe, virial = f + red[:, :3], pe + red[:, 3], virial + vb
        cell_ok = torch.all(perp_spans(Lv) / self._ncells >= self.grid.rlist)
        return f, pe, virial, ov | ~cell_ok

    def _eam(self, r_pool, s_pool, fmask, nbr, Lv, routing):
        """Two-pass EAM on the local rows' list (eam.c:39-44): densities
        and embedding on the local rows, each ghost's dF shipped from its
        owner along the halo's routing, then forces with the transposed
        density derivative (the JAX package's local_forces_eam, any
        form).  Returns (f, virial, pe) of the local rows."""
        tables = self.tables
        form, T = tables["form"], tables["n_species"]
        n_l = fmask.shape[0]
        sentinel = r_pool.shape[0]
        r_ext = torch.cat([r_pool, r_pool.new_zeros((1, 3))])
        s_ext = torch.cat([s_pool, s_pool.new_zeros((1,))])
        # per-component displacements in an orthorhombic box, the full
        # vector's minimum image under a (3, 3) h (the JAX package keeps
        # both branches, its brickstep.py:102-160)
        ortho = Lv.dim() == 1
        if ortho:
            d_c = [nearest_image(
                r_pool[:n_l, c][:, None] - r_ext[:, c][nbr], Lv[c:c + 1])
                for c in range(3)]
            r2 = d_c[0] * d_c[0] + d_c[1] * d_c[1] + d_c[2] * d_c[2]
        else:
            dr = nearest_image(r_pool[:n_l, None, :] - r_ext[nbr], Lv)
            r2 = torch.sum(dr * dr, dim=-1)
        valid = ((nbr != sentinel) & (r2 < tables["rcut2"]) & (r2 > 0)
                 & (fmask[:, None] > 0))
        w = valid.to(r_pool.dtype)
        r2s = torch.where(valid, r2, 1.0)
        ir2 = 1.0 / r2s
        ir = torch.sqrt(ir2)
        s_i, s_j = s_pool[:n_l], s_ext[nbr]
        pair_idx = s_i[:, None] * T + s_j
        e1, p1 = _pair_eval(form, tables["pair"], pair_idx, r2s, ir, ir2,
                            False)
        rho = torch.sum(p1 * w, dim=1)
        F_i, dF = _embedding(form, tables["embed"], s_i, rho)
        F_i, dF = F_i * fmask, dF * fmask
        # the second halo: owners ship dF for the same ghost rows
        dF_pool = halo_refresh_3d(dF[:, None], routing, self.plan,
                                  self.mesh)[:, 0]
        de, dp = _pair_eval(form, tables["pair"], pair_idx, r2s, ir, ir2,
                            True)
        dpT = dp if T == 1 else _pair_eval(
            form, tables["pair"], s_j * T + s_i[:, None], r2s, ir, ir2,
            True)[1]
        dF_ext = torch.cat([dF_pool, dF_pool.new_zeros((1,))])
        coef = -(de + dp * dF[:, None] + dpT * dF_ext[nbr]) * w
        if ortho:
            f = torch.stack([torch.sum(coef * d_c[c], dim=1)
                             for c in range(3)], dim=1)
            virial = 0.5 * torch.stack([
                torch.stack([torch.sum(coef * d_c[a] * d_c[b])
                             for b in range(3)]) for a in range(3)])
        else:
            fij = coef[:, :, None] * dr
            f = torch.sum(fij, dim=1)
            virial = 0.5 * torch.einsum("nka,nkb->ab", fij, dr)
        pe = 0.5 * torch.sum(e1 * w, dim=1) + F_i
        return f, virial, pe
