"""Brick-mesh MD step through the extended-grid cell kernels, one rank
per brick.

Counterpart of ddcmd_tpu/parallel/brickstep_pallas.py
(make_brick_step_pallas) for the NVT path: device-resident state, the
half-stencil kernels per rank, communication tables rebuilt at the DDC
updateRate and per-step halos against the cached tables (the reference's
choreography, ddcMD src/masters.c:389-403) --

  chunk:    rebuild: wrap -> staged halo EXCHANGE with routing capture
            (ddcSendRecvTables) -> bin local + ghost pool into the rank's
            extended cell grid (parallel/shard_cells);
            k steps: front kick -> drift (unwrapped) -> position halo
            REFRESH along the frozen routing (ddcUpdate) -> pair kernel
            over the core cells (#6), or the two EAM passes (#7) with
            the density reduce and dF refresh between them -> reverse
            force/energy reduce (ddcUpdateForce) -> back kick;
            migrate: staged 1-hop migration (ddcAssignment cadence);
  superchunk: many chunks in one dispatch, nothing read by the host
            until its end (the JAX package's superchunk, :476-498).

Per-pair work is done once across the mesh (core-cell ownership).  The
per-step scalars, virial and overflow flag are summed over the mesh in
one all-reduce.  Thermostat noise is drawn per (deck seed, global step,
rank) (core/groups.kick_noise), the counterpart of the JAX package's
fold_in(key, axis_index): it never matches a single device's noise, so
mesh and single-device runs agree in forces and energies from one state
and in ensemble means, not trajectories.

The JAX step's bonded terms, constraints, molecular virial, in-kernel
exclusions and NPT chunk are not ported (the bilayer under the mesh,
ROADMAP item 25): the step takes no such tables, and ParallelSimulation
refuses the decks that need them.
"""

from __future__ import annotations

import torch

from ..core.groups import kick_noise, velocity_update
from ..ops.cellpair_half import cellpair_half_ext
from ..ops.eam_half import eam_rho_half_ext
from ..potentials.eam import _embedding
from .brick import (BrickPlan, halo_exchange_3d, halo_reduce_3d,
                    halo_refresh_3d, migrate_3d)
from .brickstep import _volume, _wrap
from .shard_cells import (ShardCellPlan, bin_pool_ext, brick_frame_frac,
                          dev_geom, ext_L8, make_shard_eam_kernels,
                          make_shard_pair_kernel, pack_slots_ext,
                          shard_eam_force, shard_eam_rho, shard_pair_eval)

# thermostat noise callsite of the mesh step (the single-device NGLF
# step draws callsite 0); the rank rides in the bits above it
_NOISE_CALLSITE_MESH = 1


class BrickStepCells:
    """The mesh step of one rank.  fields: dict of (local_cap, ...)
    tensors r, v, q, mass, species, group, gid (int64); mask:
    (local_cap,) bool; f: (local_cap, 3).
    Every method returns new tensors and leaves its inputs untouched, so
    a caller can roll back by keeping references."""

    def __init__(self, mesh, plan: BrickPlan, cplan: ShardCellPlan, tables,
                 coeffs, dt: float, box_lengths, species_lj_type, seed: int,
                 chunk_steps: int, *, coulomb: bool = True,
                 force_kind: str = "martini"):
        if force_kind not in ("martini", "eam"):
            raise ValueError(force_kind)
        dev = mesh.device
        self.mesh, self.plan, self.cplan = mesh, plan, cplan
        self.tables, self.coeffs = tables, coeffs
        self.dt, self.seed, self.chunk_steps = dt, seed, chunk_steps
        self.coulomb, self.force_kind = coulomb, force_kind
        self.Lv = torch.as_tensor(box_lengths, dtype=torch.float32,
                                  device=dev)
        self.tmap = torch.as_tensor(species_lj_type, dtype=torch.int64,
                                    device=dev)
        self.geom = dev_geom(cplan, mesh.idx3, dev)
        self.span_cart = self.geom[1] * self.Lv
        # the cell edge must stay >= rlist (a fixed box: decided once)
        edge = self.span_cart / torch.tensor(cplan.ncore, dtype=torch.float32,
                                             device=dev)
        self._ov_cell = torch.any(edge < cplan.rlist)
        if force_kind == "eam":
            self.rho_fn, self.force_fn = make_shard_eam_kernels(cplan, tables,
                                                                dev)
        else:
            self.eval_fn = make_shard_pair_kernel(cplan, tables, coulomb, dev)
        self._generator = torch.Generator(device=dev)
        self._callsite = _NOISE_CALLSITE_MESH | (mesh.rank << 8)

    # -- rebuild: tables, routing, slot permutation (once per chunk) ------

    def _rebuild(self, fields, mask):
        fields = dict(fields, r=_wrap(fields["r"], self.Lv))
        ghosts, gmask, ov, routing = halo_exchange_3d(
            {k: fields[k] for k in ("r", "q", "species")}, mask, self.Lv,
            self.plan, self.mesh)
        pool_mask = torch.cat([mask, gmask])
        r_pool = torch.cat([fields["r"], ghosts["r"]])
        u0 = brick_frame_frac(r_pool, self.Lv, self.cplan, self.geom)
        perm, counts, ov_b = bin_pool_ext(u0, pool_mask, self.cplan)
        rb = dict(routing=routing, perm=perm, counts=counts,
                  q_pool=torch.cat([fields["q"], ghosts["q"]]),
                  tidx=self.tmap[torch.cat([fields["species"],
                                            ghosts["species"]])],
                  pool_mask=pool_mask)
        return fields, rb, ov | ov_b

    # -- forces -----------------------------------------------------------

    def _pool_frac(self, r_local, rb):
        r_pool = halo_refresh_3d(r_local, rb["routing"], self.plan, self.mesh)
        return brick_frame_frac(r_pool, self.Lv, self.cplan, self.geom)

    def _forces_eam(self, r_local, rb):
        """Two-pass EAM under the mesh (the reference's eam.c:39-44
        two-pass communication): density pass -> reverse-reduce partial
        densities home -> embedding on owners -> dF halo refresh -> force
        pass with the dF slot channel -> reverse force reduce."""
        u = self._pool_frac(r_local, rb)
        n_l = r_local.shape[0]
        rho_pe_pool, slots, L8 = shard_eam_rho(
            u, rb["tidx"], rb["perm"], rb["counts"], self.span_cart,
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
        return f, red[:, 1] + F_emb * fmask, virial

    def _forces(self, r_local, rb):
        """Pair or EAM forces reverse-reduced to the local rows: (f
        (n_loc, 3), pe (n_loc,), this rank's virial share (3, 3))."""
        if self.force_kind == "eam":
            return self._forces_eam(r_local, rb)
        u = self._pool_frac(r_local, rb)
        f_pool, virial, pe_pool = shard_pair_eval(
            u, rb["q_pool"], rb["tidx"], rb["perm"], rb["counts"],
            self.span_cart, self.cplan, self.tables, self.eval_fn)
        n_l = r_local.shape[0]
        red = halo_reduce_3d(torch.cat([f_pool, pe_pool[:, None]], dim=1),
                             rb["routing"], self.plan, n_l, self.mesh)
        return red[:, :3], red[:, 3], virial

    def _coul_self(self, rb, n_l):
        """Reaction-field self energy of the LOCAL rows (bioMartini.c:1035),
        -1/2 q^2 keR crf each: counted once across the mesh."""
        if not self.coulomb:
            return 0.0
        ql = rb["q_pool"][:n_l]
        w = rb["pool_mask"][:n_l].to(ql.dtype)
        return (-0.5 * ql * ql * w).sum() * self.tables["keR"] \
            * self.tables["crf"]

    def _reduce(self, e_pot, rk, virial, ov):
        """(e_pot, rk, virial, overflow) summed over the mesh in one
        all-reduce, the cell-edge guard folded into the overflow (a count:
        > 0 anywhere)."""
        dev = virial.device
        row = torch.cat([torch.as_tensor(e_pot, device=dev).reshape(1),
                         torch.as_tensor(rk, device=dev).reshape(1),
                         virial.reshape(9),
                         (ov | self._ov_cell).to(virial.dtype).reshape(1)])
        row = self.mesh.psum(row)
        return row[0], row[1], row[2:11].reshape(3, 3), row[11] > 0

    # -- per-step pieces --------------------------------------------------

    def _step_body(self, fields, mask, f_prev, step: int, rb, ov_r):
        """One step at global step `step` on the rebuilt tables `rb`;
        ov_r is this rank's rebuild overflow, reduced with the step's
        scalars.  Returns (fields, f, scalars (7,), overflow mesh-wide)."""
        noise = kick_noise(self._generator, self.seed, step, self._callsite,
                           (2,) + tuple(fields["r"].shape))
        half = 0.5 * self.dt
        v = velocity_update("front", fields["v"], f_prev, fields["mass"],
                            fields["group"], self.coeffs, half, noise[0], mask)
        fields = dict(fields, r=fields["r"] + self.dt * v, v=v)

        f, pe, virial = self._forces(fields["r"], rb)
        n_l = mask.shape[0]
        e_pot = pe.sum() + self._coul_self(rb, n_l)

        v = velocity_update("back", fields["v"], f, fields["mass"],
                            fields["group"], self.coeffs, half, noise[1], mask)
        fields = dict(fields, v=v)
        fmask = mask.to(v.dtype)
        rk = 0.5 * ((fields["mass"] * fmask)[:, None] * v * v).sum()
        e_pot, rk, virial, ov = self._reduce(e_pot, rk, virial, ov_r)
        vd = torch.diagonal(virial)
        scalars = torch.stack([e_pot, rk, torch.trace(virial), vd[0], vd[1],
                               vd[2], _volume(self.Lv)])
        return fields, f, scalars, ov

    # -- entry points -----------------------------------------------------

    def kernel_inputs(self, fields, mask):
        """The first kernel call _forces makes on a freshly rebuilt table:
        (kernel, (slots, stencil, L8, counts, ...tables), kw) -- the pass
        A call for EAM, whose pass B takes the same arguments -- so a
        caller can hold the kernels against their plain versions on the
        main path's inputs."""
        fields, rb, _ = self._rebuild(fields, mask)
        u = self._pool_frac(fields["r"], rb)
        q = (torch.zeros_like(rb["q_pool"]) if self.force_kind == "eam"
             else rb["q_pool"])
        slots = pack_slots_ext(u, q, rb["tidx"], rb["perm"], self.span_cart,
                               self.cplan)
        L8 = ext_L8(self.span_cart, self.cplan, self.tables["rcut2"])
        if self.force_kind == "eam":
            fn = self.rho_fn
            return (eam_rho_half_ext, (slots, fn.stencil, L8, rb["counts"],
                                       self.tables["params"]), fn.kw)
        fn = self.eval_fn
        return (cellpair_half_ext, (slots, fn.stencil, L8, rb["counts"],
                                    *fn.tabs), fn.kw)

    def first_forces(self, fields, mask):
        """(f, e_pot, virial, overflow) of the current state, mesh-wide."""
        fields, rb, ov_r = self._rebuild(fields, mask)
        f, pe, virial = self._forces(fields["r"], rb)
        e_pot = pe.sum() + self._coul_self(rb, mask.shape[0])
        e_pot, _, virial, ov = self._reduce(e_pot, 0.0, virial, ov_r)
        return f, e_pot, virial, ov

    def step(self, fields, mask, f_prev, step: int):
        """One step on a freshly rebuilt table, no migration: (fields, f,
        scalars (7,), overflow)."""
        fields, rb, ov_r = self._rebuild(fields, mask)
        return self._step_body(fields, mask, f_prev, step, rb, ov_r)

    def migrate(self, fields, mask, f):
        """Staged 1-hop migration, forces travelling with their rows:
        (fields, mask, f, overflow mesh-wide)."""
        packed, new_mask, ov = migrate_3d(dict(fields, f=f), mask, self.Lv,
                                          self.plan, self.mesh)
        f_new = packed.pop("f")
        ov = self.mesh.psum(ov.to(torch.float32).reshape(1))[0] > 0
        return packed, new_mask, f_new, ov

    def chunk(self, fields, mask, f_prev, step0: int):
        """Rebuild, chunk_steps steps at global steps step0 ..
        step0+chunk_steps-1, then migrate: (fields, mask, f, scalars
        (chunk_steps, 7), overflow)."""
        fields, rb, ov_r = self._rebuild(fields, mask)
        f, rows = f_prev, []
        ov = torch.zeros((), dtype=torch.bool, device=mask.device)
        for i in range(self.chunk_steps):
            fields, f, scal, ov_i = self._step_body(fields, mask, f,
                                                    step0 + i, rb, ov_r)
            rows.append(scal)
            ov = ov | ov_i
        fields, mask, f, ov_m = self.migrate(fields, mask, f)
        return fields, mask, f, torch.stack(rows), ov | ov_m

    def superchunk(self, fields, mask, f_prev, step0: int, n_super: int):
        """n_super chunks in one dispatch with no host read: (fields,
        mask, f, scalars (n_super*k, 7), overflow).  After an overflow
        the later chunks still run, on state the caller discards: the
        JAX superchunk freezes instead, and both hand back a flagged
        dispatch that the host rolls back whole."""
        ov = torch.zeros((), dtype=torch.bool, device=mask.device)
        rows = []
        for j in range(n_super):
            fields, mask, f_prev, scal, ov_j = self.chunk(
                fields, mask, f_prev, step0 + j * self.chunk_steps)
            rows.append(scal)
            ov = ov | ov_j
        return fields, mask, f_prev, torch.cat(rows), ov
