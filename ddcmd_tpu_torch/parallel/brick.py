"""3D brick domain decomposition over a (nx, ny, nz) rank mesh.

Counterpart of ddcmd_tpu/parallel/brick.py (the reference's CUBIC domain
lattice, ddcMD src/ddc.h:42, with plane-pruned halos, ddcSendRecv.c:
63-85), for orthorhombic and triclinic boxes.  Halo exchange and
migration use the staged scheme -- exchange +-x, then +-y including the
x ghosts, then +-z -- so three rounds of fixed-capacity buffers cover
faces, edges and corners.  Axes of one brick exchange nothing: the cell
stencil wraps there as on a single device.  An axis of two bricks sends
both windows to its one neighbour (parallel/mesh.BrickMesh.exchange
tells them apart).

Positions are GLOBAL origin-centred coordinates; ownership and halo
windows live in fractional coordinates s = r / L (s = h^-1 r in a
triclinic box, below).  With an `hgid` field (the gid of each
particle's molecule head bead) migration and the
initial distribution are molecule-coherent: the head bead's position
decides for the whole molecule (the reference's MOLECULE ddcRule,
ddcRuleMolecule.c:43).

Walls are uniform, or load balanced (parallel/loadbalance.py): tensor
walls share one (n + 1,) set of fractions per axis; ORCB walls hold y
walls per x-slab (nx, ny + 1) and z walls per (x, y) column (nx, ny,
nz + 1).  Every comparison against a wall is made in f32 with the wall
rounded to f32 first, as the JAX package compares, so that ownership
agrees with it row for row.

ORCB ghosts: the y walls differ between x-slabs, so the x-neighbour
(ix +- 1, iy, iz) does not cover this brick's y range, and the bricks
(ix +- 1, iy +- 1, .) that do reach it only as ghosts forwarded in the y
phase; likewise for z between columns.  The windows are one-sided
(x < lo + rlist goes down, x >= hi - rlist up), so a forwarded ghost
travels toward the side it lies on, measured without the periodic wrap.
On an axis of two bricks both sides reach the one neighbour and every
ghost a brick needs arrives (the JAX package's exchange, which the port
keeps there).  With three or more bricks on the y (or z) axis a ghost
that a brick needs across the periodic seam lies on the other side of
the sender and goes to the other neighbour: the JAX package misses it
and drops its pairs.  The port forwards, on such axes of ORCB plans,
every earlier-phase ghost that lies within rlist of a receiving brick's
range, across the seam too; with at most one brick of offset between
neighbouring slabs' lattices (check_orcb_reach; always so with <= 3
bricks an axis) each brick then holds every particle within rlist of
it, once.

Voronoi domains (parallel/voronoi.py, the JAX package's brick.py:
150-160, 293-330, 407-420): the plan carries dict(centers (nx, ny, nz,
3), margins (3,), L0 (3,)); a particle belongs to its nearest centre.
The halo windows widen by each axis's bisector margin, scaled with the
live box; migration routes each row (by its head bead under hgid) to the
nearest of the 27 neighbourhood centres, one staged hop per axis, and a
containment check flags an overflow, on which the run loop
redistributes on the host (assign_host).  halo_exchange_3d(centred=True)
measures the windows from the brick's centre across the periodic seam
(the list engine, whose positions are wrapped every step).

Triclinic boxes (BOX type=GENERAL, a (3, 3) h with the lattice vectors
as columns; the JAX package's brick.py:75-88, 137-170, 301-330,
400-425): ownership, walls and halo windows live in the fraction
s = h^-1 r, and a Cartesian depth w becomes the fractional window
w ||row_a(h^-1)||, the exact slab that holds every point within w of a
fractional face.  Voronoi domains run in the scaled-fractional frame
(s times the perpendicular spans), where a tilted box is Euclidean: the
centres, their margins and the nearest-centre hops live there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import inv3x3, perp_spans
from ..ops.cellpair import perp_spans as host_spans
from .slab import compact_rows

@dataclass(frozen=True)
class BrickPlan:
    shape: tuple[int, int, int]      # bricks per axis
    local_cap: int
    halo_cap: int                    # per direction per phase
    migrate_cap: int
    rlist: float
    # per-axis wall FRACTIONS from the load balancer, None = uniform:
    # tensor (n + 1,) per axis, or ORCB y (nx, ny + 1) and z (nx, ny,
    # nz + 1)
    walls: tuple | None = None
    # Voronoi domains: dict(centers (nx, ny, nz, 3), margins (3,), L0
    # (3,)), the centres and margins at box L0 (they scale with the live
    # box); mutually exclusive with walls
    voronoi: dict | None = None

    @property
    def orcb(self) -> bool:
        """Hierarchical (ORCB) walls: y or z walls per slab or column."""
        return self.walls is not None and any(
            np.asarray(w).ndim > 1 for w in self.walls)

    @property
    def n_dev(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def ghost_cap(self) -> int:
        # 2*halo per OPEN-axis phase: axes of one brick are skipped
        return 2 * self.halo_cap * sum(1 for s in self.shape if s > 1)


def geom_frac(box_geom):
    """(frac_fn, per_cart): origin-centred fractional coordinates
    s = h^-1 r (r / L for (3,) lengths) and the per-axis fractional width
    of one Cartesian length unit measured across the brick faces (1/L,
    or ||row_a(h^-1)|| for a (3, 3) h): a Cartesian halo depth w becomes
    the fractional window w * per_cart."""
    g = box_geom
    if g.dim() == 1:
        return (lambda rr: rr / g), 1.0 / g
    hin = inv3x3(g)
    return (lambda rr: rr @ hin.T), torch.sqrt(torch.sum(hin * hin, dim=1))


def _axis_bounds(n: int, idx: int, walls=None, prefix=()):
    """FRACTIONAL [lo, hi) in [-0.5, 0.5) of brick `idx` of `n` along one
    axis: uniform, or from `walls`, a shared (n + 1,) set or an ORCB set
    with one leading dimension per EARLIER axis, whose brick indices
    `prefix` holds.  Host floats rounded as the JAX package's f32
    arithmetic rounds them (brick.py:90-105 there); idx may be -1 or n
    (a neighbour across the periodic seam), its bounds then shifted by
    one box."""
    shift, idx = divmod(int(idx), n)
    f32 = np.float32
    if walls is not None:
        w = np.asarray(walls, dtype=np.float64)
        if w.ndim > 1:
            for p in prefix:
                w = w[int(p)]
        w = w.astype(f32)
        lo, hi = w[idx] - f32(0.5), w[idx + 1] - f32(0.5)
    else:
        w = f32(1.0 / n)
        lo = f32(-0.5) + w * f32(idx)
        hi = lo + w
    return float(lo) + shift, float(hi) + shift


def _near_range(x, lo: float, hi: float, win_f):
    """x within win_f of [lo, hi) on the periodic unit circle (f32)."""
    c = 0.5 * (lo + hi)
    d = x - c
    d = d - torch.round(d)
    return d.abs() < 0.5 * (hi - lo) + win_f


def check_orcb_reach(walls, shape, rlist_frac):
    """Raise ValueError unless every brick whose region comes within
    rlist of brick X (periodic) lies within one brick index of X on each
    axis: the staged exchange reaches no farther.  rlist_frac: rlist as a
    fraction of each axis.  Always holds with <= 3 bricks an axis."""
    if all(s <= 3 for s in shape):
        return
    nx, ny, nz = shape
    idx = [(i, j, k) for i in range(nx) for j in range(ny)
           for k in range(nz)]

    def ranges(i3):
        out, prefix = [], ()
        for a in range(3):
            lo, hi = _axis_bounds(shape[a], i3[a], walls[a], prefix)
            out.append((lo, hi))
            prefix = prefix + (i3[a],)
        return out

    def gap(xl, xh, yl, yh):
        """Distance between two arcs of the unit circle (0: they meet)."""
        if (yl - xl) % 1.0 < xh - xl or (xl - yl) % 1.0 < yh - yl:
            return 0.0
        return min((yl - xh) % 1.0, (xl - yh) % 1.0)

    box = {i3: ranges(i3) for i3 in idx}
    for x3 in idx:
        for y3 in idx:
            if not all(gap(*box[x3][a], *box[y3][a]) < rlist_frac[a]
                       for a in range(3)):
                continue
            for a in range(3):
                d = (y3[a] - x3[a]) % shape[a]
                if min(d, shape[a] - d) > 1:
                    raise ValueError(
                        f"ORCB walls: brick {y3} lies within rlist of brick "
                        f"{x3}, more than one brick away on axis {a}; the "
                        "staged halo exchange cannot reach it (use fewer "
                        "bricks on that axis or TENSOR walls)")


def _with_count(buf: dict, n) -> dict:
    """A buffer dict with its fill count riding along as a (1,) field."""
    return dict(buf, __n=n.reshape(1))


def halo_exchange_3d(fields: dict, valid_mask, box_geom, plan: BrickPlan,
                     mesh, centred: bool = False):
    """Collect ghost particles from all 26 neighbour bricks via 3 staged
    face exchanges.  fields: (local_cap, ...) tensors with 'r'.  With
    `centred` each window is measured from the brick's centre with the
    periodic wrap, so a row outside its brick ships toward the side it
    lies on (the same selection for a row inside).  Returns
    (ghost fields (ghost_cap, ...), ghost_mask, overflow, routing):
    `routing` holds per active phase (ax_i, src_lo, n_lo, src_hi, n_hi,
    ghost_off), src_* the POOL rows this rank put into its lo/hi windows
    (the ddcSendRecvTables analog).  halo_refresh_3d re-ships live values
    along it; halo_reduce_3d reduces ghost contributions back through
    it."""
    dev = fields["r"].device
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    ghosts = {k: v[:0] for k, v in fields.items()}
    gmask = torch.zeros((0,), dtype=torch.bool, device=dev)
    routing = []

    frac, per_cart = geom_frac(box_geom)
    pool, pool_mask = fields, valid_mask
    n_loc = valid_mask.shape[0]
    for ax_i in range(3):
        n = plan.shape[ax_i]
        if n == 1:
            continue
        me = mesh.idx3[ax_i]
        walls = None if plan.walls is None else plan.walls[ax_i]
        prefix = mesh.idx3[:ax_i]
        lo, hi = _axis_bounds(n, me, walls, prefix)
        win = plan.rlist
        if plan.voronoi is not None:
            # widened by the bisector excursion beyond the nominal face,
            # scaled with the live box
            vor = plan.voronoi
            win = win + (float(vor["margins"][ax_i]) / float(vor["L0"][ax_i])
                         / per_cart[ax_i])
        win_f = win * per_cart[ax_i]
        x = frac(pool["r"])[:, ax_i]
        if centred:
            d = x - 0.5 * (lo + hi)
            d = d - torch.round(d)
            sel_lo = pool_mask & (d < 0.5 * (lo - hi) + win_f)
            sel_hi = pool_mask & (d >= 0.5 * (hi - lo) - win_f)
        else:
            sel_lo = pool_mask & (x < lo + win_f)
            sel_hi = pool_mask & (x >= hi - win_f)
        if plan.orcb and n > 2 and pool_mask.shape[0] > n_loc:
            # forward an earlier phase's ghosts lying anywhere within
            # rlist of a receiving brick's range, across the periodic
            # seam too (module docstring)
            ghost = pool_mask.clone()
            ghost[:n_loc] = False
            sel_lo |= ghost & _near_range(
                x, *_axis_bounds(n, me - 1, walls, prefix), win_f)
            sel_hi |= ghost & _near_range(
                x, *_axis_bounds(n, me + 1, walls, prefix), win_f)
        if n == 2:
            # both windows land on the SAME neighbour: an atom within
            # rlist of both faces must ship only once or its pairs
            # double-count
            sel_hi = sel_hi & ~sel_lo
        aux = dict(pool, __row=torch.arange(pool_mask.shape[0], device=dev))
        buf_lo, n_lo, ov1 = compact_rows(aux, sel_lo, plan.halo_cap)
        buf_hi, n_hi, ov2 = compact_rows(aux, sel_hi, plan.halo_cap)
        src_lo, src_hi = buf_lo.pop("__row"), buf_hi.pop("__row")
        overflow = overflow | ov1 | ov2

        from_lo, from_hi = mesh.exchange(_with_count(buf_lo, n_lo),
                                         _with_count(buf_hi, n_hi), ax_i)
        idx = torch.arange(plan.halo_cap, device=dev)
        new_mask = torch.cat([idx < from_lo.pop("__n"),
                              idx < from_hi.pop("__n")])
        routing.append((ax_i, src_lo, n_lo, src_hi, n_hi, gmask.shape[0]))
        ghosts = {k: torch.cat([ghosts[k], from_lo[k], from_hi[k]])
                  for k in ghosts}
        gmask = torch.cat([gmask, new_mask])
        # the next phase selects from local + all ghosts so far
        pool = {k: torch.cat([fields[k], ghosts[k]]) for k in fields}
        pool_mask = torch.cat([valid_mask, gmask])

    pad = plan.ghost_cap - gmask.shape[0]
    if pad > 0:
        ghosts = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                  for k, v in ghosts.items()}
        gmask = torch.cat([gmask, gmask.new_zeros((pad,))])
    return ghosts, gmask, overflow, tuple(routing)


def halo_refresh_3d(local_vals, routing, plan: BrickPlan, mesh):
    """Re-ship per-particle values along the FROZEN routing: the per-step
    position halo against cached send lists (ddcUpdate, ddcMD
    src/ddcUpdate.c:40-89).  local_vals (local_cap, C).  Returns the
    (local_cap + ghost_cap, C) pool with the ghost rows refreshed."""
    n_local = local_vals.shape[0]
    pool = torch.cat([local_vals, local_vals.new_zeros(
        (plan.ghost_cap,) + tuple(local_vals.shape[1:]))])
    for (ax_i, src_lo, _n_lo, src_hi, _n_hi, goff) in routing:
        from_lo, from_hi = mesh.exchange({"v": pool[src_lo]},
                                         {"v": pool[src_hi]}, ax_i)
        start = n_local + goff
        pool[start:start + 2 * plan.halo_cap] = torch.cat(
            [from_lo["v"], from_hi["v"]])
    return pool


def halo_reduce_3d(pool_vals, routing, plan: BrickPlan, n_local: int, mesh):
    """Reduce ghost-row contributions back to their source rows through
    the frozen routing, phases in REVERSE (ddcUpdateForce, ddcMD
    src/ddcUpdate.c:140).  pool_vals (local_cap + ghost_cap, C), ghost
    rows holding the shares computed here for other ranks' atoms.
    Returns (local_cap, C)."""
    idx = torch.arange(plan.halo_cap, device=pool_vals.device)
    ones = (1,) * (pool_vals.dim() - 1)
    for (ax_i, src_lo, n_lo, src_hi, n_hi, goff) in reversed(routing):
        start = n_local + goff
        blk = pool_vals[start:start + 2 * plan.halo_cap]
        # our lo ghosts came from the -1 neighbour's hi window: their
        # shares go back down, and vice versa; what arrives are the
        # shares of OUR src_lo / src_hi rows
        back_lo, back_hi = mesh.exchange({"v": blk[:plan.halo_cap]},
                                         {"v": blk[plan.halo_cap:]}, ax_i)
        add_hi = torch.where((idx < n_hi).reshape((-1,) + ones),
                             back_hi["v"], 0.0)
        add_lo = torch.where((idx < n_lo).reshape((-1,) + ones),
                             back_lo["v"], 0.0)
        pool_vals = pool_vals.index_add(0, src_hi, add_hi)
        pool_vals = pool_vals.index_add(0, src_lo, add_lo)
    return pool_vals[:n_local]


def _head_positions(cur: dict, mask):
    """Each particle's molecule HEAD bead position (its own position when
    the head is not among this rank's valid rows)."""
    big = torch.iinfo(torch.int64).max
    keyed = torch.where(mask, cur["gid"], torch.full_like(cur["gid"], big))
    order = torch.argsort(keyed, stable=True)
    sgg = keyed[order]
    pos = torch.searchsorted(sgg, cur["hgid"]).clamp(0, keyed.shape[0] - 1)
    ok = (sgg[pos] == cur["hgid"])[:, None]
    return torch.where(ok, cur["r"][order[pos]], cur["r"])


def migrate_3d(fields: dict, valid_mask, box_geom, plan: BrickPlan, mesh):
    """Staged 1-hop migration along x, then y, then z (<= 1 brick hop per
    axis per call, the lazy re-bisect assumption).  With an `hgid` field
    the destination is the molecule head bead's brick, so a molecule
    always moves as one unit.  Ownership is decided on the fraction
    wrapped into the box and a particle leaves toward the nearer side
    of its brick, so one that crossed the periodic seam reaches the
    brick across it (the JAX package sends it the other way: under
    uniform or tensor walls it stays mis-owned for a chunk, harmless as
    pair ownership is positional; under ORCB walls its containment check
    flags it on every try and the run raises).  Under Voronoi domains
    each row's hops come from its nearest neighbourhood centre, computed
    once before the first hop (the JAX package's brick.py:293-330).
    Returns (fields, mask, overflow)."""
    dev = fields["r"].device
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    cur, mask = fields, valid_mask
    frac, _ = geom_frac(box_geom)
    vor = plan.voronoi
    if vor is not None:
        c27 = _voronoi_c27(plan, box_geom, mesh.idx3)
        rr = _head_positions(cur, mask) if "hgid" in cur else cur["r"]
        cur = dict(cur, __mig=_voronoi_hops(rr, c27, box_geom, plan))
    for ax_i in range(3):
        n = plan.shape[ax_i]
        if n == 1:
            continue
        if vor is not None:
            go_lo = mask & (cur["__mig"][:, ax_i] < 0)
            go_hi = mask & (cur["__mig"][:, ax_i] > 0)
        else:
            lo, hi = _bounds_of(plan, mesh.idx3, ax_i)
            rr = _head_positions(cur, mask) if "hgid" in cur else cur["r"]
            x = _in_box(frac(rr)[:, ax_i])
            # out of the brick: toward the nearer side, across the
            # periodic seam too (the JAX package compares the unwrapped
            # fraction and sends a particle that crossed the seam the
            # long way round)
            side = x - 0.5 * (lo + hi)
            below = side - torch.round(side) < 0
            out = mask & ((x < lo) | (x >= hi))
            go_lo, go_hi = out & below, out & ~below
        stay = mask & ~(go_lo | go_hi)
        buf_lo, n_lo, ov1 = compact_rows(cur, go_lo, plan.migrate_cap)
        buf_hi, n_hi, ov2 = compact_rows(cur, go_hi, plan.migrate_cap)
        from_lo, from_hi = mesh.exchange(_with_count(buf_lo, n_lo),
                                         _with_count(buf_hi, n_hi), ax_i)
        idx = torch.arange(plan.migrate_cap, device=dev)
        pool_mask = torch.cat([stay, idx < from_lo.pop("__n"),
                               idx < from_hi.pop("__n")])
        pool = {k: torch.cat([cur[k], from_lo[k], from_hi[k]]) for k in cur}
        cur, count, ov3 = compact_rows(pool, pool_mask, plan.local_cap)
        mask = torch.arange(plan.local_cap, device=dev) < count
        overflow = overflow | ov1 | ov2 | ov3
    if vor is not None:
        # containment: after the hops the nearest centre must be this
        # brick's; a row that moved more than one brick, or a centre
        # that moved under it, flags an overflow (host redistribution)
        cur = {k: v for k, v in cur.items() if k != "__mig"}
        rr = _head_positions(cur, mask) if "hgid" in cur else cur["r"]
        hops = _voronoi_hops(rr, c27, box_geom, plan)
        overflow = overflow | torch.any(mask & torch.any(hops != 0, dim=1))
        return cur, mask, overflow
    if plan.orcb:
        # crossing an x wall swaps the y and z wall sets, so one staged
        # hop can leave a particle more than one brick from its owner
        # (tensor walls cannot): check containment and flag an overflow,
        # on which the run loop redistributes on the host
        # (brick.py:366-386 of the JAX package)
        rr = _head_positions(cur, mask) if "hgid" in cur else cur["r"]
        ss = frac(rr)
        for ax_i in range(3):
            if plan.shape[ax_i] == 1:
                continue
            lo, hi = _bounds_of(plan, mesh.idx3, ax_i)
            x = _in_box(ss[:, ax_i])
            overflow = overflow | torch.any(mask & ((x < lo) | (x >= hi)))
    return cur, mask, overflow


def _voronoi_frame(rr, box_geom):
    """(positions, spans) in the Voronoi frame: Cartesian and the box
    lengths for (3,) lengths; for a (3, 3) h the scaled-fractional frame,
    s times the perpendicular spans, where a tilted box is Euclidean
    (the JAX package's brick.py:301-316)."""
    spans = perp_spans(box_geom)
    if box_geom.dim() == 1:
        return rr, spans
    return geom_frac(box_geom)[0](rr) * spans, spans


def _voronoi_c27(plan: BrickPlan, box_geom, idx3):
    """The (27, 3) neighbourhood centres of brick idx3 at the live box,
    in the Voronoi frame."""
    from .voronoi import neighborhood_centers

    vor = plan.voronoi
    L = perp_spans(box_geom)
    scale = L / torch.as_tensor(np.asarray(vor["L0"], np.float64),
                                dtype=L.dtype, device=L.device)
    centers = torch.as_tensor(np.asarray(vor["centers"], np.float64),
                              dtype=L.dtype, device=L.device) * scale
    return neighborhood_centers(centers, L, plan.shape, idx3)


def _voronoi_hops(rr, c27, box_geom, plan: BrickPlan):
    """Per-row (-1, 0, +1) hop on each axis to the nearest of the 27
    centres (Cartesian positions rr), zero on axes of one brick."""
    from .voronoi import dest_offsets

    r_v, spans = _voronoi_frame(rr, box_geom)
    hops = dest_offsets(r_v, c27, spans)
    open_ax = torch.tensor([int(n > 1) for n in plan.shape],
                           dtype=hops.dtype, device=hops.device)
    return hops * open_ax


def _in_box(x):
    """Fractions wrapped into [-0.5, 0.5) (exact in f32; a fraction
    already inside is unchanged): positions drift out of the box between
    rebuilds, and ownership is decided in it."""
    return x - torch.floor(x + 0.5)


def _bounds_of(plan: BrickPlan, idx3, ax_i: int):
    """[lo, hi) of brick idx3 along axis ax_i under the plan's walls."""
    return _axis_bounds(plan.shape[ax_i], idx3[ax_i],
                        None if plan.walls is None else plan.walls[ax_i],
                        idx3[:ax_i])


def gid64(gid) -> np.ndarray:
    """int64 global ids from either package's layout: (n,) integers, or
    the JAX package's (n, 2) uint32 [low, high] pairs."""
    g = np.asarray(gid)
    if g.ndim == 2:
        return g[:, 0].astype(np.int64) | (g[:, 1].astype(np.int64) << 32)
    return g.astype(np.int64)


def distribute_bricks(arrays: dict, box_geom, plan: BrickPlan):
    """Host-side: split arrays into flat (n_dev*local_cap, ...) buffers by
    brick; brick order is rank order, rank = (ix*ny + iy)*nz + iz.
    Returns (buffers, mask, per-brick counts).  Either package's `gid`
    layout splits into identical buffers (each keeps its own layout).
    With `hgid` a particle goes to its molecule head bead's brick; under
    load-balanced walls the owner is loadbalance.walls_assign's (in
    f64, as the JAX package assigns on the host), under Voronoi domains
    voronoi.assign_host's nearest centre (in the scaled-fractional frame
    when box_geom is a (3, 3) h)."""
    r = np.asarray(arrays["r"])
    if "hgid" in arrays:
        g64, h64 = gid64(arrays["gid"]), gid64(arrays["hgid"])
        order = np.argsort(g64, kind="stable")
        r = r[order[np.searchsorted(g64, h64, sorter=order)]]
    nx, ny, nz = plan.shape
    L = np.asarray(box_geom, dtype=np.float64)
    if L.ndim == 2:
        hin = np.linalg.inv(L)
        fr = r @ hin.T + 0.5                    # fractional, triclinic h
    else:
        fr = r / L[None, :] + 0.5
    fr = fr - np.floor(fr)
    if plan.voronoi is not None:
        from .voronoi import assign_host

        vor = plan.voronoi
        if L.ndim == 2:
            spans = host_spans(L)[0]
            r_v = (fr - 0.5) * spans          # scaled-fractional frame
        else:
            spans, r_v = L, r
        centers = np.asarray(vor["centers"]) * (
            spans / np.asarray(vor["L0"], np.float64))[None, None, None, :]
        dest = assign_host(r_v, centers, spans, plan.shape)
        cj = [dest // (ny * nz), (dest // nz) % ny, dest % nz]
    elif plan.walls is not None:
        from .loadbalance import walls_assign

        cj = walls_assign(fr, plan.walls, plan.shape)
    else:
        cj = [np.clip(np.floor(fr[:, a] * plan.shape[a]).astype(int),
                      0, plan.shape[a] - 1) for a in range(3)]
    dest = (cj[0] * ny + cj[1]) * nz + cj[2]
    counts = np.zeros(plan.n_dev, dtype=np.int32)
    for d in range(plan.n_dev):
        counts[d] = int((dest == d).sum())
        if counts[d] > plan.local_cap:
            raise ValueError(f"brick {d} needs {counts[d]} > cap {plan.local_cap}")
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        buf = np.zeros((plan.n_dev, plan.local_cap) + a.shape[1:], dtype=a.dtype)
        for d in range(plan.n_dev):
            sel = a[dest == d]
            buf[d, : len(sel)] = sel
        out[k] = buf.reshape((plan.n_dev * plan.local_cap,) + a.shape[1:])
    mask = (np.arange(plan.local_cap)[None, :] < counts[:, None]).reshape(-1)
    return out, mask, counts
