"""Brick-mesh MD step through the extended-grid cell kernels, one rank
per brick.

Counterpart of ddcmd_tpu/parallel/brickstep_pallas.py
(make_brick_step_pallas): device-resident state, the half-stencil
kernels per rank, communication tables rebuilt at the DDC updateRate and
per-step halos against the cached tables (the reference's choreography,
ddcMD src/masters.c:389-403) --

  chunk:    rebuild: wrap -> staged halo EXCHANGE with routing capture
            (ddcSendRecvTables) -> bin local + ghost pool into the rank's
            extended cell grid (parallel/shard_cells) -> resolve the
            gid-keyed bonded, constraint and molecule tables once;
            k steps: [barostat rescale] -> front kick -> RATTLE (front)
            -> drift (unwrapped) -> position halo REFRESH along the frozen
            routing (ddcUpdate) -> pair kernel over the core cells (#6,
            with in-kernel exclusions when the deck has them), or the two
            EAM passes (#7) with the density reduce and dF refresh
            between them -> batched bonded terms on the pool -> reverse
            force/energy reduce (ddcUpdateForce) -> back kick -> RATTLE
            (back);
            migrate: staged 1-hop migration (ddcAssignment cadence),
            molecule-coherent when the fields carry head gids;
  superchunk: many chunks in one dispatch, nothing read by the host
            until its end (the JAX package's superchunk, :476-526).

Per-pair work is done once across the mesh (core-cell ownership), each
bonded term, constraint group and molecule once by the rank owning its
first atom.  The per-step scalars, virial, molecular-virial correction
and overflow flag are summed over the mesh in one all-reduce.  The NPT
chunk (chunk_npt) carries the box lengths and the corrected virial
diagonal: each step first rescales the box and positions by the
Berendsen lambda (integrators/nglf.barostat_lambda, the single-device
formula); the frozen fractional cell grid and halo tables stretch
affinely with the box, and the brick and cell-edge guards flag a shrink
past rlist for the host's replan ladder.  Thermostat noise is drawn per
(deck seed, global step, rank) (core/groups.kick_noise), the counterpart
of the JAX package's fold_in(key, axis_index): it never matches a single
device's noise, so mesh and single-device runs agree in forces and
energies from one state and in ensemble means, not trajectories.
"""

from __future__ import annotations

import torch

from ..core.groups import kick_noise, velocity_update
from ..integrators.nglf import barostat_lambda
from ..ops.cellpair_half import cellpair_half_ext
from ..ops.eam_half import eam_rho_half_ext
from ..potentials.bonded_batch import batched_bonded_eval
from ..potentials.eam import _embedding
from .bonded_shard import resolve_batched, resolve_constraints
from .brick import (BrickPlan, halo_exchange_3d, halo_reduce_3d,
                    halo_refresh_3d, migrate_3d)
from .brickstep import _volume, _wrap
from .shard_cells import (ShardCellPlan, bin_frac, bin_pool_ext,
                          brick_frame_frac,
                          dev_geom, ext_L8, make_shard_eam_kernels,
                          make_shard_pair_kernel, pack_slots_ext,
                          shard_eam_force, shard_eam_rho, shard_pair_eval,
                          walls_span_minmax)

# thermostat noise callsite of the mesh step (the single-device NGLF
# step draws callsite 0); the rank rides in the bits above it
_NOISE_CALLSITE_MESH = 1


def _min_image(d, Lv):
    return d - Lv * torch.round(d / Lv)


class BrickStepCells:
    """The mesh step of one rank.  fields: dict of (local_cap, ...)
    tensors r, v, q, mass, species, group, gid (int64), and with a
    covalent topology hgid (int64, the molecule head's gid) and, with
    exclusions, excl ((local_cap, 2) f32 channels); mask: (local_cap,)
    bool; f: (local_cap, 3).

    Optional tables (host-built by run/parallel_sim): bonded_plan, a
    build_batched_bonded plan carrying gids; cons_templates, the (plan,
    project) of build_constraint_templates, or cons_tables, the
    constraint_gid_tables dict of a topology that is not
    template-regular; mol_gids, molecule_gid_tables' (M, A) gids; the
    barostat dict of the single-device Simulation; has_berendsen: some
    group is BERENDSEN (its temperature is summed over the mesh).

    Every method returns new tensors and leaves its inputs untouched, so
    a caller can roll back by keeping references."""

    def __init__(self, mesh, plan: BrickPlan, cplan: ShardCellPlan, tables,
                 coeffs, dt: float, box_lengths, species_lj_type, seed: int,
                 chunk_steps: int, *, coulomb: bool = True,
                 force_kind: str = "martini", excl: bool = False,
                 bonded_plan=None, cons_templates=None, cons_tables=None,
                 mol_gids=None, barostat=None, has_berendsen=False):
        if force_kind not in ("martini", "eam"):
            raise ValueError(force_kind)
        if force_kind == "eam" and (excl or bonded_plan is not None):
            raise ValueError("EAM decks carry no exclusions or bonded terms")
        dev = mesh.device
        self.mesh, self.plan, self.cplan = mesh, plan, cplan
        self.tables, self.coeffs = tables, coeffs
        self.dt, self.seed, self.chunk_steps = dt, seed, chunk_steps
        self.coulomb, self.force_kind, self.excl = coulomb, force_kind, excl
        self.bonded_plan, self.barostat = bonded_plan, barostat
        self.has_berendsen = has_berendsen
        self.Lv = torch.as_tensor(box_lengths, dtype=torch.float32,
                                  device=dev)
        self.tmap = torch.as_tensor(species_lj_type, dtype=torch.int64,
                                    device=dev)
        self.geom = dev_geom(cplan, mesh.idx3, dev)
        self._ncore = torch.tensor(cplan.ncore, dtype=torch.float32,
                                   device=dev)
        # the NARROWEST brick per axis as a box fraction (walls-aware):
        # the NPT shrink guard must hold for every rank
        # (brickstep_pallas.py:421-455 of the JAX package)
        self._brick_frac = torch.tensor(
            walls_span_minmax(plan.walls, plan.shape)[0],
            dtype=torch.float32, device=dev)
        if force_kind == "eam":
            self.rho_fn, self.force_fn = make_shard_eam_kernels(cplan, tables,
                                                                dev)
        else:
            self.eval_fn = make_shard_pair_kernel(cplan, tables, coulomb, dev,
                                                  excl=excl)
        self.cons_templates = None
        if cons_templates is not None:
            tplan, project = cons_templates
            types = [dict(tp, gids=tp["gids"].to(dev), d2=tp["d2"].to(dev))
                     for tp in tplan["types"]]
            self.cons_templates = (dict(types=types), project)
        self.cons_tables = None
        if cons_tables is not None:
            from ..integrators.constraints import make_constraint_project

            gids = cons_tables["cons_gids"].to(dev)
            project = make_constraint_project(
                cons_tables["cons_pairs"], cons_tables["cons_dist"],
                torch.float32, gids.shape[1], device=dev)
            self.cons_tables = (gids, project)
        self.mol_gids = None if mol_gids is None else mol_gids.to(dev)
        self.halo_keys = ("r", "q", "species") + (
            ("gid",) if bonded_plan is not None else ()) + (
            ("excl",) if excl else ())
        self._generator = torch.Generator(device=dev)
        self._callsite = _NOISE_CALLSITE_MESH | (mesh.rank << 8)

    # -- rebuild: tables, routing, slot permutation (once per chunk) ------

    def _rebuild(self, fields, mask, Lv):
        fields = dict(fields, r=_wrap(fields["r"], Lv))
        ghosts, gmask, ov, routing = halo_exchange_3d(
            {k: fields[k] for k in self.halo_keys}, mask, Lv, self.plan,
            self.mesh)
        pool_mask = torch.cat([mask, gmask])
        r_pool = torch.cat([fields["r"], ghosts["r"]])
        u0 = brick_frame_frac(r_pool, Lv, self.cplan, self.geom)
        perm, counts, ov_b = bin_pool_ext(
            bin_frac(u0, r_pool, Lv, self.cplan, self.mesh.idx3), pool_mask,
            self.cplan)
        n_l = mask.shape[0]
        rb = dict(routing=routing, perm=perm, counts=counts,
                  q_pool=torch.cat([fields["q"], ghosts["q"]]),
                  tidx=self.tmap[torch.cat([fields["species"],
                                            ghosts["species"]])],
                  pool_mask=pool_mask, bat=None, cons_bat=None, cons=None,
                  mol=None, ex_pool=None)
        if self.excl:
            rb["ex_pool"] = torch.cat([fields["excl"], ghosts["excl"]])
        if self.bonded_plan is not None:
            # residue-template terms resolve per TYPE against the pool
            rb["bat"] = resolve_batched(
                self.bonded_plan, torch.cat([fields["gid"], ghosts["gid"]]),
                pool_mask, n_l)
        if self.cons_templates is not None or self.cons_tables is not None \
                or self.mol_gids is not None:
            # owned groups and molecules are wholly local (molecule
            # coherence); inverse masses and molecule masses are static
            # within a chunk, so they are gathered here once
            rmass = torch.where(mask, 1.0 / fields["mass"].clamp(min=1e-30),
                                torch.zeros_like(fields["mass"]))
        if self.cons_templates is not None:
            tplan, _ = self.cons_templates
            rb["cons_bat"] = []
            for tp, (rows, w) in zip(tplan["types"], resolve_batched(
                    tplan, fields["gid"], mask, n_l)):
                rm2 = rmass[rows.clamp(max=n_l - 1)]
                rb["cons_bat"].append(
                    (rows, w, rm2.reshape(tp["M"], tp["A"]).T))
        if self.cons_tables is not None:
            atoms, gw = resolve_constraints(self.cons_tables[0],
                                            fields["gid"], mask, n_l)
            rb["cons"] = (atoms, gw, torch.cat([rmass, rmass.new_zeros(1)]))
        if self.mol_gids is not None:
            atoms, gw = resolve_constraints(self.mol_gids, fields["gid"],
                                            mask, n_l)
            am = (atoms < n_l).to(torch.float32)
            mm = torch.cat([fields["mass"], fields["mass"].new_zeros(1)]
                           )[atoms] * am
            rb["mol"] = (atoms, gw, mm, am,
                         mm.sum(1, keepdim=True).clamp(min=1e-30))
        return fields, rb, ov | ov_b

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
        d = _min_image(rm - rm[:, :1], Lv)
        com = (mm[:, :, None] * d).sum(1, keepdim=True) / Msum[:, :, None]
        d = (d - com) * am[:, :, None]
        return torch.einsum("m,mia,mia->a", gw, d, fm)

    # -- forces -----------------------------------------------------------

    def _pool(self, r_local, rb, Lv):
        """(pool positions, brick-frame fractions, Cartesian brick span)."""
        r_pool = halo_refresh_3d(r_local, rb["routing"], self.plan, self.mesh)
        return (r_pool, brick_frame_frac(r_pool, Lv, self.cplan, self.geom),
                self.geom[1] * Lv)

    def _forces_eam(self, r_local, rb, Lv):
        """Two-pass EAM under the mesh (the reference's eam.c:39-44
        two-pass communication): density pass -> reverse-reduce partial
        densities home -> embedding on owners -> dF halo refresh -> force
        pass with the dF slot channel -> reverse force reduce."""
        _, u, span_cart = self._pool(r_local, rb, Lv)
        n_l = r_local.shape[0]
        rho_pe_pool, slots, L8 = shard_eam_rho(
            u, rb["tidx"], rb["perm"], rb["counts"], span_cart,
            self.cplan, self.tables, self.rho_fn)
        red = halo_reduce_3d(rho_pe_pool, rb["routing"], self.plan, n_l,
                             self.mesh)
        fmask = rb["pool_mask"][:n_l].to(torch.float32)
        F_emb, dF = _embedding(self.tables["form"], self.tables["embed"],
                               rb["tidx"][:n_l], red[:, 0])
        dF_pool = halo_refresh_3d((dF * fmask)[:, None], rb["routing"],
                                  self.plan, self.mesh)[:, 0]
        f_pool, virial = shard_eam_force(slots, L8, rb["counts"], dF_pool,
                                         rb["perm"], self.cplan,
                                         self.force_fn)
        f = halo_reduce_3d(f_pool, rb["routing"], self.plan, n_l, self.mesh)
        return f, red[:, 1] + F_emb * fmask, virial, span_cart

    def _forces(self, r_local, rb, Lv):
        """Pair (or EAM) and bonded forces reverse-reduced to the local
        rows: (f (n_loc, 3), pe (n_loc,), this rank's virial share (3, 3),
        overflow: a live cell edge below rlist)."""
        if self.force_kind == "eam":
            f, pe, virial, span_cart = self._forces_eam(r_local, rb, Lv)
        else:
            r_pool, u, span_cart = self._pool(r_local, rb, Lv)
            f_pool, virial, pe_pool = shard_pair_eval(
                u, rb["q_pool"], rb["tidx"], rb["perm"], rb["counts"],
                span_cart, self.cplan, self.tables, self.eval_fn,
                ex_pool=rb["ex_pool"])
            if rb["bat"] is not None:
                fb, _, vb, peb = batched_bonded_eval(
                    r_pool, Lv, self.bonded_plan, r_pool.shape[0],
                    torch.float32, resolved=rb["bat"])
                f_pool, pe_pool = f_pool + fb, pe_pool + peb
                virial = virial + vb
            n_l = r_local.shape[0]
            red = halo_reduce_3d(torch.cat([f_pool, pe_pool[:, None]], dim=1),
                                 rb["routing"], self.plan, n_l, self.mesh)
            f, pe = red[:, :3], red[:, 3]
        # the live cell edge must stay >= rlist (the NPT shrink guard)
        return f, pe, virial, torch.any(span_cart / self._ncore
                                        < self.cplan.rlist)

    def _coul_self(self, rb, n_l):
        """Reaction-field self energy of the LOCAL rows (bioMartini.c:1035),
        -1/2 q^2 keR crf each: counted once across the mesh."""
        if not self.coulomb:
            return 0.0
        ql = rb["q_pool"][:n_l]
        w = rb["pool_mask"][:n_l].to(ql.dtype)
        return (-0.5 * ql * ql * w).sum() * self.tables["keR"] \
            * self.tables["crf"]

    def _reduce(self, e_pot, rk, virial, corr, ov):
        """(e_pot, rk, virial, molecular-virial correction (3,), overflow)
        summed over the mesh in one all-reduce; the overflow flag rides
        as a count (> 0 anywhere)."""
        dev = virial.device
        row = torch.cat([torch.as_tensor(e_pot, device=dev).reshape(1),
                         torch.as_tensor(rk, device=dev).reshape(1),
                         virial.reshape(9), corr.reshape(3),
                         ov.to(virial.dtype).reshape(1)])
        row = self.mesh.psum(row)
        return (row[0], row[1], row[2:11].reshape(3, 3), row[11:14],
                row[14] > 0)

    # -- per-step pieces --------------------------------------------------

    def _step_body(self, fields, mask, f_prev, step: int, rb, ov, Lv):
        """One step at global step `step` on the rebuilt tables `rb` at the
        live box Lv; ov is this rank's overflow so far, reduced with the
        step's scalars.  Returns (fields, f, scalars (7,), overflow
        mesh-wide); scalars [e_pot, rk, tr virial, molecular virial
        diagonal (3), volume]."""
        noise = kick_noise(self._generator, self.seed, step, self._callsite,
                           (2,) + tuple(fields["r"].shape))
        half = 0.5 * self.dt
        # a BERENDSEN group's temperature sums over every rank
        v = velocity_update("front", fields["v"], f_prev, fields["mass"],
                            fields["group"], self.coeffs, half, noise[0], mask,
                            self.has_berendsen, group_sum=self.mesh.psum)
        v = self._rattle(fields["r"], v, True, Lv, rb)
        fields = dict(fields, r=fields["r"] + self.dt * v, v=v)

        f, pe, virial, ov_c = self._forces(fields["r"], rb, Lv)
        n_l = mask.shape[0]
        e_pot = pe.sum() + self._coul_self(rb, n_l)

        v = velocity_update("back", fields["v"], f, fields["mass"],
                            fields["group"], self.coeffs, half, noise[1], mask)
        v = self._rattle(fields["r"], v, False, Lv, rb)
        fields = dict(fields, v=v)
        fmask = mask.to(v.dtype)
        rk = 0.5 * ((fields["mass"] * fmask)[:, None] * v * v).sum()
        corr = (self._mol_corr(fields["r"], f, Lv, rb) if rb["mol"] is not None
                else virial.new_zeros(3))
        e_pot, rk, virial, corr, ov = self._reduce(e_pot, rk, virial, corr,
                                                   ov | ov_c)
        vd = torch.diagonal(virial) - corr
        scalars = torch.stack([e_pot, rk, torch.trace(virial), vd[0], vd[1],
                               vd[2], _volume(Lv)])
        return fields, f, scalars, ov

    # -- entry points -----------------------------------------------------

    def kernel_inputs(self, fields, mask, Lv=None):
        """The first kernel call _forces makes on a freshly rebuilt table
        (at box Lv, the deck's box by default): (kernel, (slots, stencil,
        L8, counts, ...tables), kw) -- the pass A call for EAM, whose pass
        B takes the same arguments -- so a caller can hold the kernels
        against their plain versions on the main path's inputs."""
        Lv = self.Lv if Lv is None else Lv
        fields, rb, _ = self._rebuild(fields, mask, Lv)
        _, u, span_cart = self._pool(fields["r"], rb, Lv)
        q = (torch.zeros_like(rb["q_pool"]) if self.force_kind == "eam"
             else rb["q_pool"])
        slots = pack_slots_ext(u, q, rb["tidx"], rb["perm"], span_cart,
                               self.cplan, rb["ex_pool"])
        L8 = ext_L8(span_cart, self.cplan, self.tables["rcut2"])
        if self.force_kind == "eam":
            fn = self.rho_fn
            return (eam_rho_half_ext, (slots, fn.stencil, L8, rb["counts"],
                                       fn.params), fn.kw)
        fn = self.eval_fn
        return (cellpair_half_ext, (slots, fn.stencil, L8, rb["counts"],
                                    *fn.tabs), fn.kw)

    def first_forces(self, fields, mask, Lv=None):
        """(f, e_pot, virial, overflow) of the current state at box Lv
        (the deck's box by default), mesh-wide; the virial's diagonal
        carries the molecular correction, as the barostat reads it."""
        Lv = self.Lv if Lv is None else Lv
        fields, rb, ov_r = self._rebuild(fields, mask, Lv)
        f, pe, virial, ov_c = self._forces(fields["r"], rb, Lv)
        e_pot = pe.sum() + self._coul_self(rb, mask.shape[0])
        corr = (self._mol_corr(fields["r"], f, Lv, rb) if rb["mol"] is not None
                else virial.new_zeros(3))
        e_pot, _, virial, corr, ov = self._reduce(e_pot, 0.0, virial, corr,
                                                  ov_r | ov_c)
        return f, e_pot, virial - torch.diag(corr), ov

    def step(self, fields, mask, f_prev, step: int):
        """One step on a freshly rebuilt table, no migration: (fields, f,
        scalars (7,), overflow)."""
        fields, rb, ov_r = self._rebuild(fields, mask, self.Lv)
        return self._step_body(fields, mask, f_prev, step, rb, ov_r, self.Lv)

    def migrate(self, fields, mask, f, Lv=None):
        """Staged 1-hop migration at box Lv, forces travelling with their
        rows: (fields, mask, f, overflow mesh-wide)."""
        packed, new_mask, ov = migrate_3d(
            dict(fields, f=f), mask, self.Lv if Lv is None else Lv,
            self.plan, self.mesh)
        f_new = packed.pop("f")
        ov = self.mesh.psum(ov.to(torch.float32).reshape(1))[0] > 0
        return packed, new_mask, f_new, ov

    def chunk(self, fields, mask, f_prev, step0: int):
        """Rebuild, chunk_steps steps at global steps step0 ..
        step0+chunk_steps-1, then migrate: (fields, mask, f, scalars
        (chunk_steps, 7), overflow)."""
        fields, rb, ov = self._rebuild(fields, mask, self.Lv)
        f, rows = f_prev, []
        for i in range(self.chunk_steps):
            fields, f, scal, ov = self._step_body(fields, mask, f, step0 + i,
                                                  rb, ov, self.Lv)
            rows.append(scal)
        fields, mask, f, ov_m = self.migrate(fields, mask, f)
        return fields, mask, f, torch.stack(rows), ov | ov_m

    def chunk_npt(self, fields, mask, f_prev, vird, Lv, step0: int,
                  steps: int | None = None):
        """NPT chunk of `steps` (chunk_steps by default) steps: rebuild at
        the live box, then per step the Berendsen lambda from the last
        step's molecular virial diagonal `vird` rescales Lv and the
        positions before the step; the brick guard flags a brick narrower
        than rlist.  Returns (fields, mask, f, vird, Lv, scalars (steps,
        7), overflow)."""
        fields, rb, ov = self._rebuild(fields, mask, Lv)
        f, rows = f_prev, []
        for i in range(self.chunk_steps if steps is None else steps):
            lam = barostat_lambda(vird, _volume(Lv), self.barostat, self.dt)
            Lv = Lv * lam
            ov = ov | torch.any(self._brick_frac * Lv < self.plan.rlist)
            fields = dict(fields, r=fields["r"] * lam)
            fields, f, scal, ov = self._step_body(fields, mask, f, step0 + i,
                                                  rb, ov, Lv)
            vird = scal[3:6]
            rows.append(scal)
        fields, mask, f, ov_m = self.migrate(fields, mask, f, Lv)
        return fields, mask, f, vird, Lv, torch.stack(rows), ov | ov_m

    def superchunk(self, fields, mask, f_prev, step0: int, n_super: int,
                   vird=None, Lv=None):
        """n_super chunks (NPT chunks when the barostat is on, carrying
        vird and Lv) in one dispatch with no host read.  Returns ((fields,
        mask, f[, vird, Lv]), scalars (n_super*k, 7), overflow).  After an
        overflow the later chunks still run, on state the caller
        discards: the JAX superchunk freezes instead, and both hand back
        a flagged dispatch that the host rolls back whole."""
        k = self.chunk_steps
        ov = torch.zeros((), dtype=torch.bool, device=mask.device)
        state = (fields, mask, f_prev) + (
            () if self.barostat is None else (vird, Lv))
        rows = []
        for j in range(n_super):
            if self.barostat is None:
                *state, scal, ov_j = self.chunk(*state, step0 + j * k)
            else:
                out = self.chunk_npt(*state, step0 + j * k)
                state, scal, ov_j = out[:5], out[5], out[6]
            rows.append(scal)
            ov = ov | ov_j
        return tuple(state), torch.cat(rows), ov
