"""1-D slab decomposition over a ring of ranks, and the fixed-capacity
row compaction every halo and migration buffer of the meshes is packed
with.

Counterpart of ddcmd_tpu/parallel/slab.py, the reference's DDC layer
(ddcMD src/ddc.c, ddcSendRecv.c, ddcUpdate.c, ddcAssignment.c) cut to
x-slabs:

  * domains: x-slabs over n ranks, uniform or between load-balanced
    wall fractions (parallel/loadbalance.zramp_walls), the CUBIC domain
    lattice's 1-D case;
  * the ring: parallel/mesh.BrickMesh at shape (n, 1, 1), whose exchange
    moves both one-hop buffers along x at fixed capacity with their fill
    counts beside them;
  * halo exchange (ddcUpdate, ddcSendRecvTables): each rank ships the
    rows within rlist of its faces to the neighbour across that face;
  * migration (ddcAssignment, ddcExchangeParticles) at the rebuild
    cadence, one slab hop at most (a row that would need more flags the
    overflow, the reference's lazy re-bisect trigger,
    bisectionCalc.c:118-133);
  * global scalars sum over the ring (parallel/step.py).

Three departures from the JAX slab engine, each where it would lose or
double-count pairs: the halo windows are measured from the slab's centre
with the periodic wrap, so a row that crossed the seam since the last
migration still ships toward the side it lies on (the JAX windows
compare the raw x and ship it the other way, as its brick windows do,
ROADMAP section 3); on a ring of two a row near both faces ships once
and a migrant goes one way, not both; and a ring of one exchanges
nothing, where the JAX engine sends a rank its own rows as ghosts.

The brick mesh (parallel/brick.py) generalises all of this to three
axes; the slab engine keeps the JAX package's slab API (with
parallel/step.py) and a slab plan's pxyz file (io/pxyz.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def compact_rows(arrays: dict, mask, out_cap: int):
    """Pack the rows where `mask` is True to the front of (out_cap, ...)
    zero-filled buffers, in row order.  Returns (packed dict, count as a
    0-d int64 tensor clipped to out_cap, overflow as a 0-d bool tensor):
    static shapes, no host read; rows past out_cap are dropped and flag
    the overflow."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    count = pos[-1] + 1 if mask.shape[0] else torch.zeros(
        (), dtype=torch.int64, device=mask.device)
    slot = torch.where(mask & (pos < out_cap), pos,
                       torch.full_like(pos, out_cap))
    out = {}
    for k, a in arrays.items():
        buf = torch.zeros((out_cap + 1,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        buf[slot] = a
        out[k] = buf[:out_cap]
    return out, torch.clamp(count, max=out_cap), count > out_cap


@dataclass(frozen=True)
class SlabPlan:
    n_dev: int
    local_cap: int       # max owned particles per rank
    halo_cap: int        # max ghosts per side
    migrate_cap: int     # max migrants per side per rebuild
    rlist: float
    # non-uniform wall FRACTIONS (n_dev + 1,) from the load balancer
    # (parallel.loadbalance.zramp_walls); None = uniform slabs
    walls: tuple | None = None


def slab_bounds(box_lx: float, n_dev: int, dev_idx: int, walls=None):
    """[lo, hi) of slab dev_idx in origin-centred global x (host
    floats)."""
    if walls is not None:
        w = np.asarray(walls, dtype=np.float64)
        return ((float(w[dev_idx]) - 0.5) * box_lx,
                (float(w[dev_idx + 1]) - 0.5) * box_lx)
    w = box_lx / n_dev
    lo = -0.5 * box_lx + w * dev_idx
    return lo, lo + w


def _slab_of(x, box_lx: float, plan: SlabPlan):
    """The owning slab of each x (wrapped positions), walls-aware."""
    frac = x / box_lx + 0.5
    if plan.walls is not None:
        w = torch.as_tensor(np.asarray(plan.walls, np.float64),
                            dtype=x.dtype, device=x.device)
        s = torch.searchsorted(w, frac.contiguous(), right=True) - 1
        return s.clamp(0, plan.n_dev - 1)
    return torch.floor(frac * plan.n_dev).to(torch.int64).clamp(
        0, plan.n_dev - 1)


def _ring_exchange(send_lo: dict, n_lo, send_hi: dict, n_hi, mesh):
    """Both one-hop shifts along the ring with the fill counts beside
    the buffers: (from_lo, n_from_lo, from_hi, n_from_hi), what the -1 /
    +1 neighbours sent toward this rank."""
    from_lo, from_hi = mesh.exchange(dict(send_lo, __n=n_lo.reshape(1)),
                                     dict(send_hi, __n=n_hi.reshape(1)), 0)
    return (from_lo, from_lo.pop("__n")[0], from_hi,
            from_hi.pop("__n")[0])


def send_masks(x, valid_mask, box_lx: float, plan: SlabPlan, rank: int):
    """The rows of slab `rank` that its halo ships, (toward the -1
    neighbour, toward the +1 neighbour): the valid rows within rlist of
    its lo and hi faces, measured from the slab's centre with the
    periodic wrap (x: the rows' wrapped positions)."""
    lo, hi = slab_bounds(box_lx, plan.n_dev, rank, plan.walls)
    d = x - 0.5 * (lo + hi)
    d = d - box_lx * torch.round(d / box_lx)
    half = 0.5 * (hi - lo)
    send_lo = valid_mask & (d < -half + plan.rlist)
    send_hi = valid_mask & (d >= half - plan.rlist)
    if plan.n_dev == 2:
        # both windows reach the one neighbour: a row near both faces
        # ships once, or its pairs double-count
        send_hi = send_hi & ~send_lo
    return send_lo, send_hi


def halo_exchange(fields: dict, valid_mask, box_lx: float, plan: SlabPlan,
                  mesh):
    """Ghosts from both neighbours.  fields: per-rank (local_cap, ...)
    tensors with 'r' (wrapped positions); mesh: the (n, 1, 1) ring.
    Returns (ghost fields (2 * halo_cap, ...), ghost mask, overflow):
    the -1 neighbour's rows first, then the +1 neighbour's."""
    dev = fields["r"].device
    idx = torch.arange(plan.halo_cap, device=dev)
    if plan.n_dev == 1:
        # one slab: the minimum image covers the box, nothing to ship
        ghosts = {k: v.new_zeros((2 * plan.halo_cap,) + tuple(v.shape[1:]))
                  for k, v in fields.items()}
        return (ghosts, torch.zeros(2 * plan.halo_cap, dtype=torch.bool,
                                    device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    send_lo, send_hi = send_masks(fields["r"][:, 0], valid_mask, box_lx,
                                  plan, mesh.rank)
    buf_lo, n_lo, ov_lo = compact_rows(fields, send_lo, plan.halo_cap)
    buf_hi, n_hi, ov_hi = compact_rows(fields, send_hi, plan.halo_cap)
    from_lo, c_lo, from_hi, c_hi = _ring_exchange(buf_lo, n_lo, buf_hi,
                                                  n_hi, mesh)
    ghosts = {k: torch.cat([from_lo[k], from_hi[k]]) for k in fields}
    gmask = torch.cat([idx < c_lo, idx < c_hi])
    return ghosts, gmask, ov_lo | ov_hi


def migrate(fields: dict, valid_mask, box_lx: float, plan: SlabPlan, mesh):
    """Move the rows whose x left this slab to the neighbour that owns
    it (one hop at most; a row owned farther away flags the overflow).
    Returns (fields, valid mask, count, overflow), this rank's."""
    dev = fields["r"].device
    me, n = mesh.rank, plan.n_dev
    dest = _slab_of(fields["r"][:, 0], box_lx, plan)
    stay = valid_mask & (dest == me)
    go_hi = valid_mask & (dest == (me + 1) % n) & (n > 1)
    # on a ring of two both hops reach the one neighbour: go once
    go_lo = valid_mask & (dest == (me - 1) % n) & (n > 1) & ~go_hi
    lost = valid_mask & ~(stay | go_hi | go_lo)
    overflow = torch.any(lost)
    if n == 1:
        packed, count, ov = compact_rows(fields, stay, plan.local_cap)
        return (packed, torch.arange(plan.local_cap, device=dev) < count,
                count, overflow | ov)
    buf_lo, n_lo, ov_lo = compact_rows(fields, go_lo, plan.migrate_cap)
    buf_hi, n_hi, ov_hi = compact_rows(fields, go_hi, plan.migrate_cap)
    from_lo, c_lo, from_hi, c_hi = _ring_exchange(buf_lo, n_lo, buf_hi,
                                                  n_hi, mesh)
    idx = torch.arange(plan.migrate_cap, device=dev)
    pool = {k: torch.cat([fields[k], from_lo[k], from_hi[k]]) for k in fields}
    pool_mask = torch.cat([stay, idx < c_lo, idx < c_hi])
    packed, count, ov_pack = compact_rows(pool, pool_mask, plan.local_cap)
    new_mask = torch.arange(plan.local_cap, device=dev) < count
    return packed, new_mask, count, overflow | ov_lo | ov_hi | ov_pack


def distribute(arrays: dict, box_lx: float, plan: SlabPlan):
    """Host-side: split host arrays by x-slab into flat (n_dev *
    local_cap, ...) buffers, rank r's rows at [r * local_cap, (r + 1) *
    local_cap).  Returns (buffers, mask, per-slab counts)."""
    x = np.asarray(arrays["r"])[:, 0]
    if plan.walls is not None:
        dest = np.clip(np.searchsorted(np.asarray(plan.walls),
                                       x / box_lx + 0.5, side="right") - 1,
                       0, plan.n_dev - 1)
    else:
        dest = np.clip(np.floor((x / box_lx + 0.5) * plan.n_dev).astype(int),
                       0, plan.n_dev - 1)
    out = {}
    counts = np.zeros(plan.n_dev, dtype=np.int32)
    for d in range(plan.n_dev):
        counts[d] = int((dest == d).sum())
        if counts[d] > plan.local_cap:
            raise ValueError(f"slab {d} needs {counts[d]} > cap "
                             f"{plan.local_cap}")
    for k, a in arrays.items():
        a = np.asarray(a)
        buf = np.zeros((plan.n_dev, plan.local_cap) + a.shape[1:],
                       dtype=a.dtype)
        for d in range(plan.n_dev):
            sel = a[dest == d]
            buf[d, : len(sel)] = sel
        out[k] = buf.reshape((plan.n_dev * plan.local_cap,) + a.shape[1:])
    mask = (np.arange(plan.local_cap)[None, :] < counts[:, None]).reshape(-1)
    return out, mask, counts


def collect(fields: dict, mask, plan: SlabPlan, mesh=None) -> dict:
    """The valid rows of every slab on the host, in rank order: from the
    flat buffers distribute made (mesh None), or from each rank's
    (local_cap, ...) tensors gathered over the ring (collective; every
    rank gets the result)."""
    def host(t):
        if mesh is not None:
            t = mesh.all_gather(t)
            t = t.reshape((-1,) + tuple(t.shape[2:]))
        return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    m = host(mask).astype(bool)
    return {k: host(v)[m] for k, v in fields.items()}
