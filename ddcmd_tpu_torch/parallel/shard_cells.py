"""Per-brick extended cell grid for the half-stencil kernels.

Counterpart of ddcmd_tpu/parallel/pallas_shard.py: the single-device
cell-pair and EAM kernels running inside the brick-mesh step -- the
reference's "fastest engine under domain decomposition" (device-resident
state plus MPI halos, ddcMD src/masters.c:389-403) on a rank mesh.

Geometry: every rank owns a brick and plans an EXTENDED cell grid --

  * core cells exactly tile the brick (the same ncore on every rank:
    under uniform walls the union of all core cells is one GLOBAL cell
    lattice; under load-balanced walls each rank's cell edge is its own
    span / ncore, ncore planned from the narrowest brick, so every edge
    clears rlist);
  * on open axes (mesh size > 1) one halo cell is appended per side, as
    wide as the core cells (under uniform walls it coincides with the
    neighbour brick's boundary core cell);
  * on periodic axes (mesh size 1) the core cells span the whole box and
    the stencil wraps as on a single device;
  * one SENTINEL cell (always empty) ends the slot array: stencil
    directions that leave the extended grid on an open axis point at it.

Pair ownership (Newton's third law across the mesh): the block pair
(c, c + positive d) is evaluated by the rank whose CORE cell c is -- the
kernels run programs over core cells only -- so every unordered pair is
evaluated once mesh-wide; the q-side reactions that land in halo cells
go home through the reverse halo reduce (parallel/brick.halo_reduce_3d).
Under walls the argument holds face by face: two bricks that differ
first along axis a share their lattices along the earlier axes (a slab
shares its x walls, a column its y walls), and across their a-face the
offset is +1 in one frame and -1 in the other, so exactly one of them
sees the pair at a positive half-stencil direction, whatever their
lattices along the later axes.

The kernels are the extended-grid entry points of the port's half-stencil
kernels (ops/cellpair_half.cellpair_half_ext, ops/eam_half.eam_*_half_ext,
TPU kernels #6 and #7).  Unlike the TPU kernel's trimmed p side, they trim
both loops with per-cell counts, so `bin_pool_ext` counts every slot cell
(halo cells included, the sentinel 0).  Records carry the in-kernel
exclusion channels of the pool rows when the step passes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.cellpair import _half_dirs
from ..ops.cellpair_half import cellpair_half_ext, plan_lanes
from ..ops.eam_half import (eam_force_half_ext, eam_half_supported,
                            eam_kernel_tables, eam_rho_half_ext)


@dataclass(frozen=True)
class ShardCellPlan:
    """Host-side plan of the per-rank extended cell grid (identical on
    every rank).  Cell centres are BRICK-NORMALIZED: fractions of the
    owning brick's span, so the tables are rank-independent."""
    shape: tuple[int, int, int]          # mesh shape
    ncore: tuple[int, int, int]          # core cells per axis per brick
    cap: int                             # slots per cell
    rlist: float
    open_axes: tuple[bool, bool, bool]   # mesh size > 1 per axis
    next3: tuple[int, int, int] = field(default=None)   # extended dims
    n_prog: int = 0                      # prod(ncore) = kernel programs
    n_slot: int = 0                      # cells in the slot array (+sentinel)
    ext2slot: np.ndarray = None          # (prod(next3),) raveled ext -> slot
    slot2ext: np.ndarray = None          # (n_slot, 3) ext coords per slot
    stencil_packed: np.ndarray = None    # (n_prog, 14*4) [slot,dx,dy,dz]
    alias_groups: tuple = ()
    center_frac: np.ndarray = None       # (n_slot, 3) BRICK-NORMALIZED centres
    walls: tuple | None = None           # BrickPlan.walls (None: uniform)
    span_frac_min: np.ndarray = None     # (3,) narrowest brick per axis

    @property
    def sentinel_cell(self) -> int:
        return self.n_slot - 1


def _build_ext_tables(ncore, open_axes):
    """Slot ordering (core cells first, halo shell after, sentinel last)
    and the ext-coordinate <-> slot maps."""
    off = np.array([1 if o else 0 for o in open_axes])
    next3 = tuple(int(ncore[a]) + 2 * int(open_axes[a]) for a in range(3))
    ex, ey, ez = np.meshgrid(np.arange(next3[0]), np.arange(next3[1]),
                             np.arange(next3[2]), indexing="ij")
    e3 = np.stack([ex, ey, ez], axis=-1).reshape(-1, 3)     # raveled ext
    is_core = np.all((e3 >= off) & (e3 < off + np.asarray(ncore)), axis=1)
    core3 = e3 - off
    core_ravel = (core3[:, 0] * ncore[1] + core3[:, 1]) * ncore[2] \
        + core3[:, 2]
    n_prog = int(np.prod(ncore))
    slot = np.empty(len(e3), np.int32)
    slot[is_core] = core_ravel[is_core].astype(np.int32)
    halo_rows = np.nonzero(~is_core)[0]
    slot[halo_rows] = n_prog + np.arange(len(halo_rows), dtype=np.int32)
    n_slot = n_prog + len(halo_rows) + 1                    # + sentinel
    slot2ext = np.zeros((n_slot, 3), np.int32)
    slot2ext[slot] = e3
    return next3, n_prog, n_slot, slot, slot2ext


def _pack_stencil_ext(ncore, open_axes, next3, ext2slot, n_slot):
    """(n_prog, 14*4) int32 [slot_id, dx, dy, dz] per half-stencil
    direction.  d stays the UNWRAPPED offset so the kernel's q shift
    d * cell_width is exact for plain neighbours, periodic wraps and
    (inert: the sentinel is empty) out-of-range entries alike."""
    off = np.array([1 if o else 0 for o in open_axes])
    dirs = _half_dirs()
    n_prog = int(np.prod(ncore))
    cells = np.arange(n_prog)
    cx, rem = np.divmod(cells, ncore[1] * ncore[2])
    cy, cz = np.divmod(rem, ncore[2])
    c3 = np.stack([cx, cy, cz], axis=1) + off               # ext coords
    packed = np.zeros((n_prog, len(dirs), 4), np.int32)
    for s, d in enumerate(dirs):
        t = c3 + np.asarray(d)
        oob = np.zeros(n_prog, bool)
        for a in range(3):
            if open_axes[a]:
                oob |= (t[:, a] < 0) | (t[:, a] >= next3[a])
            else:
                t[:, a] %= next3[a]
        tr = np.clip((t[:, 0] * next3[1] + t[:, 1]) * next3[2] + t[:, 2],
                     0, np.prod(next3) - 1)
        packed[:, s, 0] = np.where(oob, n_slot - 1, ext2slot[tr])
        packed[:, s, 1:4] = d
    return packed.reshape(n_prog, -1)


def _alias_groups_ext(ncore, open_axes):
    """Half-stencil directions grouped by the neighbour cell they reach:
    on periodic axes with <= 2 cells two directions can hit one cell
    through different images.  Kept for parity with the JAX plan: the
    kernels add the q side with atomics (index_add_ in the plain
    versions), exact under aliasing, so nothing merges them."""
    groups: dict = {}
    for s, d in enumerate(_half_dirs()):
        key = tuple(d[a] if open_axes[a] else d[a] % ncore[a]
                    for a in range(3))
        groups.setdefault(key, []).append(s)
    return tuple(tuple(v) for v in groups.values())


def walls_span_minmax(walls, shape):
    """(min, max) brick-span FRACTIONS per axis of a BrickPlan.walls tuple
    (tensor 1-D, or ORCB 2-D / 3-D); 1/shape on axes without walls
    (ddcmd_tpu/parallel/pallas_shard.py:160-175)."""
    mins = np.empty(3)
    maxs = np.empty(3)
    for a in range(3):
        w = None if walls is None else walls[a]
        if w is None:
            mins[a] = maxs[a] = 1.0 / shape[a]
        else:
            d = np.diff(np.asarray(w, dtype=np.float64), axis=-1)
            mins[a] = float(d.min())
            maxs[a] = float(d.max())
    return mins, maxs


def plan_shard_cells(box_lengths, shape, rcut, skin, n_global,
                     density_safety: float = 1.3, plan_margin: float = 1.0,
                     walls=None) -> ShardCellPlan:
    """Plan the per-rank extended grid: fat core cells over the brick span
    (open axes) or the whole box (periodic axes), at the GLOBAL density
    (ops/cellpair_half.plan_lanes).  plan_margin > 1 keeps the cell edge
    >= rlist * plan_margin: shrink headroom for a barostat.  The JAX
    package's plan at its default lane capacity and density safety.

    With load-balanced `walls` (BrickPlan.walls): ncore comes from the
    NARROWEST brick, so every rank's cell edge clears rlist, and the cap
    from the per-brick count inflated by prod(span_max / span_min), so
    the shared cap covers the densest cell of the widest brick (the JAX
    package's plan, pallas_shard.py:177-226)."""
    L = np.asarray(box_lengths, dtype=np.float64)
    shape = tuple(int(s) for s in shape)
    open_axes = tuple(s > 1 for s in shape)
    sf_min, sf_max = walls_span_minmax(walls, shape)
    spans = sf_min * L
    rlist = rcut + skin
    for a in range(3):
        if open_axes[a] and spans[a] < rlist:
            raise ValueError(
                f"axis {a}: brick span {spans[a]:.4f} < rlist {rlist:.4f}"
                " -- 1-hop halos cannot cover the cutoff; use fewer "
                "bricks along this axis (or looser wall clamps)")
    n_brick = max(1, int(math.ceil(n_global / float(np.prod(shape)))))
    infl = float(np.prod(np.maximum(sf_max / np.maximum(sf_min, 1e-12),
                                    1.0)))
    g = plan_lanes(spans, rcut, skin, int(math.ceil(n_brick * infl)),
                   density_safety=density_safety, plan_margin=plan_margin)
    ncore = g.ncells
    next3, n_prog, n_slot, ext2slot, slot2ext = _build_ext_tables(
        ncore, open_axes)
    stencil = _pack_stencil_ext(ncore, open_axes, next3, ext2slot, n_slot)
    off = np.array([1 if o else 0 for o in open_axes])
    centers = (slot2ext - off + 0.5) / np.asarray(ncore, np.float64) - 0.5
    centers[-1] = 0.0                                      # sentinel: inert
    return ShardCellPlan(
        shape=shape, ncore=tuple(int(x) for x in ncore), cap=g.cap,
        rlist=g.rlist, open_axes=open_axes, next3=next3, n_prog=n_prog,
        n_slot=n_slot, ext2slot=ext2slot, slot2ext=slot2ext,
        stencil_packed=stencil,
        alias_groups=_alias_groups_ext(ncore, open_axes),
        center_frac=centers.astype(np.float64), walls=walls,
        span_frac_min=sf_min)


def dev_geom(plan: ShardCellPlan, idx3, device):
    """This rank's brick geometry: (c_off (3,), span_frac (3,)) f32 --
    the brick's centre offset and span as fractions of the box, uniform
    or looked up in the plan's wall tables (ORCB y walls by the x index,
    z walls by the x and y indices), rounded as the JAX package's f32
    arithmetic (pallas_shard.py:229-261).  Closed axes span the box."""
    f32 = np.float32
    c, s = [], []
    for a in range(3):
        if not plan.open_axes[a]:
            c.append(f32(0.0))
            s.append(f32(1.0))
            continue
        w = None if plan.walls is None else plan.walls[a]
        if w is None:
            lo = f32(idx3[a]) / f32(plan.shape[a])
            hi = (f32(idx3[a]) + f32(1.0)) / f32(plan.shape[a])
        else:
            w = np.asarray(w, dtype=np.float64).astype(f32)
            w = w[tuple(idx3[:w.ndim - 1])]
            lo, hi = w[idx3[a]], w[idx3[a] + 1]
        c.append(f32(0.5) * (lo + hi) - f32(0.5))
        s.append(hi - lo)
    return (torch.tensor(np.array(c, f32), device=device),
            torch.tensor(np.array(s, f32), device=device))


def brick_frame_frac(r, Lv, plan: ShardCellPlan, geom):
    """BRICK-NORMALIZED positions relative to the brick centre (open
    axes: (frac - centre)/span, ghost images unwrapped onto this brick's
    side of the box); periodic axes keep the raw unwrapped box fraction,
    as positions stay unwrapped between rebuilds on a single device."""
    c_off, span = geom
    s = r / Lv
    cols = []
    for a in range(3):
        if plan.open_axes[a]:
            u = s[:, a] - c_off[a]
            u = u - torch.round(u)
            cols.append(u / span[a])
        else:
            cols.append(s[:, a])
    return torch.stack(cols, dim=1)


def bin_frac(u, r, Lv, plan: ShardCellPlan, idx3):
    """The brick-frame fractions `u` to bin with: on each open axis a row
    lies in the core exactly when its box fraction, wrapped into the box,
    passes the f32 wall comparison of parallel/brick.py (lo <= x < hi,
    the comparison that decides ownership), else in the halo cell on its
    side.  u = (x - centre) / span rounds on its own in each brick's
    frame, so a row on a shared wall (ORCB walls split between equal
    coordinates, a lattice layer) could otherwise fall in both bricks'
    cores or in neither, and its pairs across the wall be counted twice
    or not at all.  Only the binning moves; the packed coordinates keep
    u."""
    from .brick import _axis_bounds, _in_box

    below = torch.nextafter(torch.tensor(0.5, dtype=u.dtype),
                            torch.tensor(0.0, dtype=u.dtype)).item()
    cols = []
    for a in range(3):
        ua = u[:, a]
        if plan.open_axes[a]:
            lo, hi = _axis_bounds(plan.shape[a], idx3[a],
                                  None if plan.walls is None
                                  else plan.walls[a], idx3[:a])
            x = _in_box(r[:, a] / Lv[a])
            side = x - 0.5 * (lo + hi)
            low = side - torch.round(side) < 0
            core = (x >= lo) & (x < hi)
            ua = torch.where(core, ua.clamp(-0.5, below),
                             torch.where(low, ua.clamp(max=-below),
                                         ua.clamp(min=0.5)))
        cols.append(ua)
    return torch.stack(cols, dim=1)


def bin_pool_ext(u, pool_mask, plan: ShardCellPlan):
    """Slot permutation over the extended grid from brick-normalized
    fractions `u` (brick_frame_frac).  Returns (perm (n_slot*cap,) int64
    slot -> pool row [empty n_pool], counts (n_slot,) int32 -- every slot
    cell's occupancy, halo cells included and the sentinel 0 -- and the
    overflow flag).  The argsort is stable, so perm equals the JAX
    package's."""
    n_pool = u.shape[0]
    dev = u.device
    exi = []
    for a in range(3):
        n_c = plan.ncore[a]
        ix = torch.floor((u[:, a] + 0.5) * n_c).to(torch.int64)
        if plan.open_axes[a]:
            ix = torch.clamp(ix + 1, 0, n_c + 1)            # halo offset +1
        else:
            ix = torch.clamp(ix, 0, n_c - 1)
        exi.append(ix)
    ext_ravel = (exi[0] * plan.next3[1] + exi[1]) * plan.next3[2] + exi[2]
    cell = torch.as_tensor(plan.ext2slot, dtype=torch.int64,
                           device=dev)[ext_ravel]
    cid = torch.where(pool_mask, cell, torch.full_like(cell, plan.n_slot))

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(n_pool, device=dev) - first
    ok = rank < plan.cap
    flat = torch.where(ok, sorted_cid * plan.cap + rank,
                       torch.full_like(rank, (plan.n_slot + 1) * plan.cap))
    perm = torch.full(((plan.n_slot + 2) * plan.cap,), n_pool,
                      dtype=torch.int64, device=dev)
    perm[flat] = order
    perm = perm[: plan.n_slot * plan.cap]
    overflow = torch.any(~ok & (sorted_cid < plan.n_slot))
    counts = (perm.reshape(plan.n_slot, plan.cap) != n_pool).sum(
        dim=1, dtype=torch.int32)
    return perm, counts, overflow


def pack_slots_ext(u, q, tidx, perm, span_cart, plan: ShardCellPlan,
                   ex_pool=None):
    """(n_slot, 8, cap) slot records in CELL-CENTRED brick-frame Cartesian
    coordinates, rows [x y z q type valid ex6 ex7]: ex6/ex7 are the pool
    rows' in-kernel exclusion channels (n_pool, 2) (run/forces.
    _excl_channels; ghosts carry their owners' values), zero without
    exclusions.  span_cart (3,): this rank's Cartesian brick span."""
    dt = torch.float32
    n_pool = u.shape[0]
    dev = u.device
    n_slot, cap = plan.n_slot, plan.cap
    centers = torch.as_tensor(plan.center_frac, dtype=dt,
                              device=dev) * span_cart
    zero = torch.zeros((1,), dtype=dt, device=dev)
    r_ext = torch.cat([u.to(dt) * span_cart, zero.expand(1, 3)])
    q_ext = torch.cat([q.to(dt), zero])
    t_ext = torch.cat([tidx.to(dt), zero])
    v_ext = torch.cat([torch.ones((n_pool,), dtype=dt, device=dev), zero])
    P = r_ext[perm].reshape(n_slot, cap, 3) - centers[:, None, :]
    if ex_pool is None:
        ex = torch.zeros((n_slot, cap, 2), dtype=dt, device=dev)
    else:
        ex = torch.cat([ex_pool.to(dt), zero.expand(1, 2)])[perm]
        ex = ex.reshape(n_slot, cap, 2)
    rec = torch.cat([
        P,
        q_ext[perm].reshape(n_slot, cap, 1),
        t_ext[perm].reshape(n_slot, cap, 1),
        v_ext[perm].reshape(n_slot, cap, 1),
        ex,
    ], dim=2)
    return rec.transpose(1, 2).contiguous()


def ext_L8(span_cart, plan: ShardCellPlan, rcut2: float):
    """(1, 8) f32 [cell width (3), rcut^2, 0...] of this rank's grid."""
    L8 = torch.zeros((1, 8), dtype=torch.float32, device=span_cart.device)
    L8[0, :3] = span_cart / torch.tensor(plan.ncore, dtype=torch.float32,
                                         device=span_cart.device)
    L8[0, 3] = rcut2
    return L8


# ---------------------------------------------------------------------------
# kernel factories (core-cell programs over the extended slot array)
# ---------------------------------------------------------------------------

def make_shard_pair_kernel(plan: ShardCellPlan, tables, coulomb: bool,
                           device, excl: bool = False):
    """The LJ + RF sweep over the n_prog CORE cells with slot space over
    the n_slot extended cells (TPU kernel #6); excl=True masks the pairs
    the record rows 6-7 exclude.  Returns eval(slots, L8, counts) -> (p
    side (n_prog*cap, 4) [f, pe], accumulated q side (n_slot, 8, cap),
    per-core-cell (n_prog, 8) [e, virial6])."""
    stencil = torch.as_tensor(plan.stencil_packed, device=device)
    tabs = [torch.as_tensor(tables[k], dtype=torch.float32,
                            device=device).contiguous()
            for k in ("sigma", "eps", "shift")]
    kw = dict(krf=float(tables["krf"]), crf=float(tables["crf"]),
              keR=float(tables["keR"]), coulomb=coulomb, excl=excl)

    def eval_fn(slots, L8, counts):
        return cellpair_half_ext(slots, stencil, L8, counts, *tabs, **kw)

    eval_fn.stencil, eval_fn.tabs, eval_fn.kw = stencil, tabs, kw
    return eval_fn


def make_shard_eam_kernels(plan: ShardCellPlan, tables, device):
    """The two EAM passes over the CORE cells with slot space over the
    extended cells (TPU kernel #7).  `tables` from
    potentials/eam.eam_device_tables (or ops/eam_half.eam_kernel_tables);
    a deck the kernels cannot take raises ValueError.  Returns (rho_fn,
    force_fn): rho_fn(slots, L8, counts) -> (p side (n_prog*cap, 2), q side (n_slot,
    8, cap)); force_fn(slots, L8, counts) -> (p-side force (n_prog*cap,
    3), q side (n_slot, 8, cap), per-core-cell (n_prog, 8) [virial6])."""
    if not eam_half_supported(tables):
        raise ValueError(
            f"EAM form {tables['form']} with {tables['n_species']} species: "
            "the EAM kernels take the analytic forms and the "
            "tabularFit=rational refit with 1-4 species; the mesh's engine "
            "pick sends the rest to the brick list engine, as the JAX "
            "package's does (run/parallel_sim._pick_shard_engine)")
    tables = eam_kernel_tables(tables)
    stencil = torch.as_tensor(plan.stencil_packed, device=device)
    params = tables["params"]
    kw = dict(form=tables["kform"], T=int(tables["n_species"]),
              degree=tables["degree"])

    def rho_fn(slots, L8, counts):
        return eam_rho_half_ext(slots, stencil, L8, counts, params, **kw)

    def force_fn(slots, L8, counts):
        return eam_force_half_ext(slots, stencil, L8, counts, params, **kw)

    for fn in (rho_fn, force_fn):
        fn.stencil, fn.params, fn.kw = stencil, params, kw
    return rho_fn, force_fn


def _slot_to_pool(back_flat, perm, n_pool):
    """Scatter slot-space values (n_slot*cap, C) to pool rows through the
    binning permutation (empty slots land in the dropped row n_pool)."""
    out = back_flat.new_zeros((n_pool + 1, back_flat.shape[1]))
    out[perm] = back_flat
    return out[:n_pool]


def _virial(v6):
    return torch.stack([v6[0], v6[3], v6[4],
                        v6[3], v6[1], v6[5],
                        v6[4], v6[5], v6[2]]).reshape(3, 3)


def shard_eam_rho(u, tidx, perm, counts, span_cart, plan: ShardCellPlan,
                  tables, rho_fn):
    """Pass 1: per-pool-row partial (rho, pe_pair) -- the q-side shares
    on ghost rows are the caller's to reverse-reduce home (the
    reference's first EAM communication, eam.c:39-44).  Returns
    ((n_pool, 2), slots, L8)."""
    n_pool = u.shape[0]
    q0 = torch.zeros((n_pool,), dtype=torch.float32, device=u.device)
    slots = pack_slots_ext(u, q0, tidx, perm, span_cart, plan)
    L8 = ext_L8(span_cart, plan, tables["rcut2"])
    out_p, acc = rho_fn(slots, L8, counts)
    back = acc[:, 0:2, :].transpose(1, 2).reshape(plan.n_slot * plan.cap, 2)
    npc = plan.n_prog * plan.cap
    back = torch.cat([back[:npc] + out_p, back[npc:]])
    return _slot_to_pool(back, perm, n_pool), slots, L8


def shard_eam_force(slots, L8, counts, dF_pool, perm, plan: ShardCellPlan,
                    force_fn):
    """Pass 2: forces with the dF channel (slot row 6) filled from the
    dF-refreshed pool.  Returns (f_pool (n_pool, 3), virial (3, 3))."""
    n_pool = dF_pool.shape[0]
    dF_ext = torch.cat([dF_pool.to(torch.float32),
                        dF_pool.new_zeros((1,), dtype=torch.float32)])
    slots2 = slots.clone()
    slots2[:, 6, :] = dF_ext[perm].reshape(plan.n_slot, plan.cap)
    out_f, acc, out_cells = force_fn(slots2, L8, counts)
    back = acc[:, 0:3, :].transpose(1, 2).reshape(plan.n_slot * plan.cap, 3)
    npc = plan.n_prog * plan.cap
    back = torch.cat([back[:npc] + out_f, back[npc:]])
    return (_slot_to_pool(back, perm, n_pool),
            _virial(out_cells[:, 0:6].sum(dim=0)))


def shard_pair_eval(u, q, tidx, perm, counts, span_cart, plan: ShardCellPlan,
                    tables, eval_fn, ex_pool=None):
    """Per-rank pair forces, virial and per-row energy on the POOL (local
    + ghost) rows.  Each block pair is evaluated once mesh-wide
    (core-cell ownership); the returned f / pe carry the ghost rows'
    reaction shares, which the caller must reverse-reduce home
    (halo_reduce_3d).  ex_pool (n_pool, 2): the exclusion channels, for
    an eval_fn made with excl=True.  Returns (f (n_pool, 3), virial
    (3, 3), pe (n_pool,))."""
    n_pool = u.shape[0]
    slots = pack_slots_ext(u, q, tidx, perm, span_cart, plan, ex_pool)
    L8 = ext_L8(span_cart, plan, tables["rcut2"])
    out_p, out_q, out_cells = eval_fn(slots, L8, counts)
    back = out_q[:, 0:4, :].transpose(1, 2).reshape(plan.n_slot * plan.cap, 4)
    npc = plan.n_prog * plan.cap
    back = torch.cat([back[:npc] + out_p, back[npc:]])
    fpe = _slot_to_pool(back, perm, n_pool)
    return fpe[:, 0:3], _virial(out_cells[:, 1:7].sum(dim=0)), fpe[:, 3]
