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
            between them -> bonded terms on the pool (batched per residue
            type, per term for the rest) -> reverse
            force/energy reduce (ddcUpdateForce) -> back kick -> RATTLE
            (back);
            migrate: staged 1-hop migration (ddcAssignment cadence),
            molecule-coherent when the fields carry head gids;
  superchunk: many chunks in one dispatch, nothing read by the host
            until its end (the JAX package's superchunk, :476-526).

Per-pair work is done once across the mesh (core-cell ownership), each
bonded term, constraint group and molecule once by the rank owning its
first atom.  The per-step scalars, virial, molecular-virial correction
and overflow flag are summed over the mesh in one all-reduce.  A chunk
carries the box and barostat state (BrickStepBase.chunk): each step
moves the box by the deck's rule -- the Berendsen lambda, box(t),
NPTGLF's zeta or NGLFNK's pistons, the single-device formulas -- and
the rows with it; the frozen fractional cell grid and halo tables
stretch affinely with the box, and the brick and cell-edge guards flag
a shrink past rlist for the host's replan ladder.  Thermostat noise is drawn per
(deck seed, global step, rank) (core/groups.kick_noise), the counterpart
of the JAX package's fold_in(key, axis_index): it never matches a single
device's noise, so mesh and single-device runs agree in forces and
energies from one state and in ensemble means, not trajectories.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cellpair_half import cellpair_half_ext
from ..ops.eam_half import eam_rho_half_ext
from ..potentials.eam import _embedding
from .brick import (BrickPlan, halo_exchange_3d, halo_reduce_3d,
                    halo_refresh_3d)
from ..core.box import nearest_image
from .brickstep import BrickStepBase
from .shard_cells import (ShardCellPlan, bin_frac, bin_pool_ext,
                          brick_frame_frac,
                          dev_geom, ext_L8, make_shard_eam_kernels,
                          make_shard_pair_kernel, pack_slots_ext,
                          shard_eam_force, shard_eam_rho, shard_pair_eval,
                          walls_span_minmax)


class BrickStepCells(BrickStepBase):
    """The mesh step of one rank on the extended-grid kernels (f32).
    fields as BrickStepBase's, and with exclusions excl ((local_cap, 2)
    f32 channels); the bonded and constraint tables as BrickStepBase
    takes them."""

    def __init__(self, mesh, plan: BrickPlan, cplan: ShardCellPlan, tables,
                 coeffs, dt: float, box_lengths, species_lj_type, seed: int,
                 chunk_steps: int, *, coulomb: bool = True,
                 force_kind: str = "martini", excl: bool = False, **kw):
        if force_kind not in ("martini", "eam"):
            raise ValueError(force_kind)
        if force_kind == "eam" and (excl or kw.get("bonded_plan") is not None
                                    or kw.get("bonded_left") is not None):
            raise ValueError("EAM decks carry no exclusions or bonded terms")
        # the extended cell grids are orthorhombic (dev_geom, bin_frac): a
        # triclinic deck takes the list engine, as the JAX pick sends it
        assert np.ndim(box_lengths) == 1, "the cells engine takes (3,) lengths"
        super().__init__(mesh, plan, tables, coeffs, dt, box_lengths,
                         species_lj_type, seed, chunk_steps,
                         force_kind=force_kind, dtype=torch.float32, **kw)
        dev = mesh.device
        # a per-step rebuild bins every row where it lies (_rebuild_guard
        # covers what that cannot); a chunk's binning is frozen, so a long
        # chunk needs the drift guard
        self.drift_in_step = False
        self.cplan, self.coulomb, self.excl = cplan, coulomb, excl
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
        bonded = self.bonded_plan is not None or self.bonded_left is not None
        self.halo_keys = ("r", "q", "species") + (
            ("gid",) if bonded else ()) + (("excl",) if excl else ())

    # -- rebuild: tables, routing, slot permutation (once per chunk) ------

    def _rebuild(self, fields, mask, Lv):
        fields = dict(fields, r=nearest_image(fields["r"], Lv))
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
                  pool_mask=pool_mask, bat=None, left=None, ex_pool=None,
                  pe_self=None)
        if self.coulomb:
            # the reaction-field self energy of each LOCAL row
            # (bioMartini.c:1035), -1/2 q^2 keR crf: counted once across
            # the mesh, once a rebuild
            q = fields["q"]
            rb["pe_self"] = (-0.5 * self.tables["keR"] * self.tables["crf"]
                             * q * q * mask.to(q.dtype))
        if self.excl:
            rb["ex_pool"] = torch.cat([fields["excl"], ghosts["excl"]])
        if "gid" in self.halo_keys:
            # residue-template terms resolve per TYPE against the pool,
            # the rest (junctions, CMAP) per term
            rb["bat"], rb["left"] = self._resolve_bonded(
                torch.cat([fields["gid"], ghosts["gid"]]), pool_mask, n_l)
        self._resolve_local(fields, mask, rb)
        return fields, rb, ov | ov_b

    def _narrow(self, Lv):
        return torch.any(self._brick_frac * Lv < self.plan.rlist)

    def _rebuild_guard(self, fields, mask, Lv):
        """A rebuild between migrations bins each row where it lies, and on
        an axis of three or more bricks a row outside its brick can sit
        in a cell whose pairs a brick two away evaluates, which the staged
        exchange does not reach (or, across the periodic seam, ship the
        wrong way): flag any owned row (its molecule head under hgid)
        outside its brick on such an axis, by the wall comparison that
        decides ownership.  Axes of one or two bricks take any excursion
        (every neighbour of the cell holding the row is within one brick
        of its owner)."""
        from .brick import _bounds_of, _head_positions, _in_box

        out = torch.zeros((), dtype=torch.bool, device=mask.device)
        if all(n < 3 for n in self.plan.shape):
            return out
        r = _head_positions(fields, mask) if "hgid" in fields else fields["r"]
        for a, n in enumerate(self.plan.shape):
            if n < 3:
                continue
            lo, hi = _bounds_of(self.plan, self.mesh.idx3, a)
            x = _in_box(r[:, a] / Lv[a])
            out = out | torch.any(mask & ((x < lo) | (x >= hi)))
        return out

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
            bond = self._bonded_pool(r_pool, Lv, rb["bat"], rb["left"])
            if bond is not None:
                f_pool, pe_pool = f_pool + bond[0], pe_pool + bond[1]
                virial = virial + bond[2]
            n_l = r_local.shape[0]
            red = halo_reduce_3d(torch.cat([f_pool, pe_pool[:, None]], dim=1),
                                 rb["routing"], self.plan, n_l, self.mesh)
            f, pe = red[:, :3], red[:, 3]
        # the live cell edge must stay >= rlist (the NPT shrink guard)
        return f, pe, virial, torch.any(span_cart / self._ncore
                                        < self.cplan.rlist)

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
