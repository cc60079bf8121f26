"""The MD step over the 1-D slab ring.

Counterpart of ddcmd_tpu/parallel/step.py: one reference MD step on a
slab decomposition -- halo exchange (ddcUpdate) -> the (N,K) neighbour
list of the local rows over local and ghost rows -> martini_nonbond ->
the group kicks and the drift -> energy, kinetic energy and virial
summed over the ring -- and migration (ddcAssignment) at the caller's
cadence.  Plain PyTorch: the JAX package builds it from plain XLA, so
there is no kernel on this path.

make_sharded_step returns the JAX package's three callables, per rank:

  step(fields, mask, f_prev, step) -> (fields, f, scalars (3,), overflow)
  first(fields, mask)              -> (f, e_pot, virial, overflow)
  migrate(fields, mask, f)         -> (fields, mask, f, overflow)

fields are this rank's (local_cap, ...) tensors r, v, q, mass, species,
group (and gid); scalars [e_pot, rk, tr virial] and the overflow flag
(any rank's halo, list or migration overflow) are ring-wide.  Where the
JAX step takes a PRNG key, this one takes the global step number: the
thermostat noise is kick_noise's, re-seeded from (seed, step, callsite,
rank), so a rerun of a step draws the same numbers.
"""

from __future__ import annotations

import torch

from ..core.groups import kick_noise, velocity_update
from ..nbr.celllist import build_neighbor_list
from ..potentials.martini import martini_nonbond
from .mesh import BrickMesh
from .slab import SlabPlan, halo_exchange, migrate

FIELD_KEYS = ("r", "v", "q", "mass", "species", "group", "gid")
# the slab step's thermostat callsite; the rank rides in the bits above
_NOISE_CALLSITE_SLAB = 2


def pool_forces(r_ext, q_ext, s_ext, mask, gmask, Lv, grid, tables, tmap):
    """One rank's nonbond forces: the local rows (the first mask.shape[0]
    of the pool r_ext, q_ext, s_ext) against local and valid ghost rows
    (gmask), through the (N,K) list of the local rows and
    martini_nonbond.  Returns (f (n_loc, 3), e_pot, virial, pe, list
    overflow)."""
    n_loc = mask.shape[0]
    bin_mask = torch.cat([mask, gmask]).to(r_ext.dtype)
    row_mask = torch.cat([mask, torch.zeros_like(gmask)]).to(r_ext.dtype)
    nbr, _, ov = build_neighbor_list(r_ext, bin_mask, Lv, grid,
                                     row_mask=row_mask, n_rows=n_loc)
    f, e_pot, virial, pe, _ = martini_nonbond(
        r_ext, q_ext, tmap[s_ext], mask.to(r_ext.dtype), nbr, Lv, tables,
        n_rows=n_loc)
    return f, e_pot, virial, pe, ov


def make_mesh(n_devices: int | None = None, device="cpu") -> BrickMesh:
    """The ring of n_devices ranks (the world of torch.distributed by
    default; one rank without a process group) on `device`: a BrickMesh
    of shape (n, 1, 1)."""
    import torch.distributed as dist

    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return BrickMesh((int(n_devices), 1, 1), device)


def make_sharded_step(mesh: BrickMesh, plan: SlabPlan, grid, tables, coeffs,
                      dt: float, box_lengths, species_lj_type, n_global: int,
                      n_constraints: int = 0, seed: int = 0):
    """(step, first, migrate) of this rank on the slab ring `mesh`: the
    MARTINI nonbond term (martini_device_tables, or a PAIR deck's tables
    with zero reaction-field constants) on the global CellGrid `grid` at
    the orthorhombic box `box_lengths` (3,), group kicks from `coeffs`
    (GroupTable.coefficients).  n_global and n_constraints are the JAX
    signature's and unused there too."""
    del n_global, n_constraints
    dev = mesh.device
    dtype = tables["sigma"].dtype
    Lv = torch.as_tensor(box_lengths, dtype=dtype, device=dev)
    if Lv.dim() != 1:
        raise ValueError("the slab step takes an orthorhombic box, (3,) "
                         "lengths; a triclinic h runs on the brick mesh")
    box_lx = float(Lv[0])
    tmap = torch.as_tensor(species_lj_type, dtype=torch.int64, device=dev)
    half = 0.5 * dt
    generator = torch.Generator(device=dev)
    callsite = _NOISE_CALLSITE_SLAB | (mesh.rank << 8)

    def reduce(row):
        """One all-reduce of a step's scalars, the overflow flag last."""
        row = mesh.psum(row)
        return row[:-1], row[-1] > 0

    def local_forces(fields, mask):
        ghosts, gmask, ov = halo_exchange(
            {k: fields[k] for k in ("r", "q", "species")}, mask, box_lx,
            plan, mesh)
        f, e_pot, virial, pe, nbr_ov = pool_forces(
            *(torch.cat([fields[k], ghosts[k]]) for k in ("r", "q",
                                                           "species")),
            mask, gmask, Lv, grid, tables, tmap)
        return f, e_pot, virial, pe, ov | nbr_ov

    def step(fields, mask, f_prev, step_idx: int):
        noise = kick_noise(generator, seed, step_idx, callsite,
                           (2,) + tuple(fields["r"].shape),
                           dtype=fields["v"].dtype)
        v = velocity_update("front", fields["v"], f_prev, fields["mass"],
                            fields["group"], coeffs, half, noise[0], mask)
        r = fields["r"] + dt * v
        r = r - Lv * torch.round(r / Lv)          # back in the periodic box
        fields = dict(fields, r=r, v=v)
        f, e_pot, virial, _, ov = local_forces(fields, mask)
        v = velocity_update("back", fields["v"], f, fields["mass"],
                            fields["group"], coeffs, half, noise[1], mask)
        fields = dict(fields, v=v)
        fmask = mask.to(v.dtype)
        rk = 0.5 * ((fields["mass"] * fmask)[:, None] * v * v).sum()
        tot, ov = reduce(torch.cat([e_pot.reshape(1), rk.reshape(1),
                                    torch.trace(virial).reshape(1),
                                    ov.to(v.dtype).reshape(1)]))
        return fields, f, tot, ov

    def first(fields, mask):
        f, e_pot, virial, _, ov = local_forces(fields, mask)
        tot, ov = reduce(torch.cat([e_pot.reshape(1), virial.reshape(9),
                                    ov.to(virial.dtype).reshape(1)]))
        return f, tot[0], tot[1:].reshape(3, 3), ov

    def migrate_fn(fields, mask, f):
        # forces ride along, so the next front kick reads each row's own
        packed, new_mask, _, ov = migrate(dict(fields, f=f), mask, box_lx,
                                          plan, mesh)
        f_new = packed.pop("f")
        ov = mesh.psum(ov.to(torch.float32).reshape(1))[0] > 0
        return packed, new_mask, f_new, ov

    return step, first, migrate_fn
