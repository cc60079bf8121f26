"""Cell-block grid, stencils, sort-based binning and the plain
cell-block pair engine.

Counterpart of ddcmd_tpu/ops/cellpair.py.  At each rebuild particles are
binned into a static cell grid (edge >= rcut + skin), stably argsorted
into slot order, and the slot->particle permutation is kept; the pair
kernels then sweep every slot pair of a cell against its half stencil.
Minimum image is replaced by per-(cell, stencil-direction) integer image
wraps, exact for every pair within the cutoff because the cell edge >=
rlist -- which requires positions to stay unwrapped between rebuilds.

A triclinic box bins in fractional coordinates, with as many cells per
axis as its perpendicular span holds, and maps the integer wraps and the
cell centres through h (`block_geometry`).  `cellpair_eval_half` is the
JAX package's XLA cell-block engine in plain PyTorch: every (cell, slot,
stencil slot) pair as one dense tensor, in any dtype, on any geometry and
with non-periodic axes (`pbc_allowed`).  It launches no hand-written
kernel (in the JAX package it reaches no Pallas kernel either), and its
(ncell, cap, 14 cap) intermediates size it for small decks.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import inv3x3


@dataclass(frozen=True)
class CellBlockGrid:
    ncells: tuple[int, int, int]
    cap: int                  # max particles per cell
    rlist: float
    # static stencil (host numpy):
    stencil_cells: np.ndarray   # (ncell, S) int32 neighbor cell ids
    wrap: np.ndarray            # (ncell, S, 3) int8 image wrap counts

    @property
    def ncell(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @property
    def n_stencil(self) -> int:
        return self.stencil_cells.shape[1]

    @classmethod
    def plan(cls, box_geom, rcut: float, skin: float, n_particles: int,
             density_safety: float = 1.6,
             plan_margin: float = 1.0) -> "CellBlockGrid":
        """The cell-block engine's plan (CellBlockGrid.plan of the JAX
        package): box_geom (3,) lengths or a (3,3) h; cells per axis from
        the perpendicular span over rlist * plan_margin (plan_margin > 1
        keeps a shrinking box's cell edge >= rlist longer), cap from the
        mean occupancy times density_safety, plus 4, rounded up to a
        multiple of 8."""
        spans, vol = perp_spans(box_geom)
        rlist = rcut + skin
        ncells = tuple(max(1, int(math.floor(s / (rlist * plan_margin))))
                       for s in spans)
        cell_vol = vol / np.prod(ncells)
        cap = int(n_particles / vol * cell_vol * density_safety) + 4
        stencil_cells, wrap = _build_stencil(ncells)
        return cls(ncells=ncells, cap=((cap + 7) // 8) * 8, rlist=rlist,
                   stencil_cells=stencil_cells, wrap=wrap)

    def with_cap(self, cap: int) -> "CellBlockGrid":
        return dataclasses.replace(self, cap=((cap + 7) // 8) * 8)


def perp_spans(box_geom):
    """Perpendicular spans (3,) and volume of a (3,) or (3,3) box (host)."""
    g = np.asarray(box_geom, dtype=np.float64)
    if g.ndim == 1:
        return g.copy(), float(np.prod(g))
    a = g.T  # rows = lattice vectors
    vol = float(abs(np.linalg.det(g)))
    spans = np.array([vol / np.linalg.norm(np.cross(a[(i + 1) % 3],
                                                    a[(i + 2) % 3]))
                      for i in range(3)])
    return spans, vol


def frac_coords(r, box_geom):
    """Fractional coordinates in [0,1) of origin-centred positions for a
    (3,) or (3,3) box geometry."""
    if box_geom.dim() == 1:
        return r / box_geom + 0.5
    return r @ inv3x3(box_geom).T + 0.5


def block_geometry(grid: "CellBlockGrid", box_geom, dtype):
    """Cartesian image shifts (C,S,3) and cell centres (C,3): the static
    integer wraps and fractional cell centres mapped through the live
    (possibly barostat-scaled) box, elementwise for (3,) lengths,
    through h^T for a (3,3) h."""
    dev = box_geom.device
    b = box_geom.to(dtype)
    wrap = torch.as_tensor(grid.wrap, dtype=dtype, device=dev)
    c3 = np.stack(_cell_coords(grid.ncells), axis=1)
    sfrac = torch.as_tensor((c3 + 0.5) / np.asarray(grid.ncells) - 0.5,
                            dtype=dtype, device=dev)
    if b.dim() == 1:
        return wrap * b, sfrac * b
    return wrap @ b.T, sfrac @ b.T


def _cell_coords(ncells):
    nx, ny, nz = ncells
    cells = np.arange(nx * ny * nz)
    cx, rem = np.divmod(cells, ny * nz)
    cy, cz = np.divmod(rem, nz)
    return cx, cy, cz


def _stencil_from_offsets(ncells, offs):
    nx, ny, nz = ncells
    cx, cy, cz = _cell_coords(ncells)
    ncell = nx * ny * nz
    stencil = np.zeros((ncell, len(offs)), dtype=np.int32)
    wrap = np.zeros((ncell, len(offs), 3), dtype=np.int8)
    for s, (dx, dy, dz) in enumerate(offs):
        tx, ty, tz = cx + dx, cy + dy, cz + dz
        # wrap counts: how many boxes the neighbor cell image is offset by
        wrap[:, s, 0] = (tx >= nx).astype(np.int8) - (tx < 0).astype(np.int8)
        wrap[:, s, 1] = (ty >= ny).astype(np.int8) - (ty < 0).astype(np.int8)
        wrap[:, s, 2] = (tz >= nz).astype(np.int8) - (tz < 0).astype(np.int8)
        stencil[:, s] = ((tx % nx) * ny + (ty % ny)) * nz + (tz % nz)
    return stencil, wrap


def _build_stencil(ncells):
    """Full 27-direction stencil: per-cell neighbor ids + image wraps.
    Offsets are always (-1, 0, 1) per axis: on a 2-cell axis -1 and +1
    reach the same neighbor through different images and both count."""
    offs = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]
    return _stencil_from_offsets(ncells, offs)


def _half_dirs():
    """The 14 half-stencil directions: self first, then the 13
    lexicographically positive offsets."""
    return [(0, 0, 0)] + [
        (i, j, k)
        for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
        if (i, j, k) > (0, 0, 0)]


def _build_stencil_half(ncells):
    """Newton's-third-law half stencil: the self block FIRST (index 0,
    deduplicated in the kernel by keeping j > i) + the 13 positive
    directions; each unordered pair appears in exactly one block."""
    return _stencil_from_offsets(ncells, _half_dirs())


def half_grid(grid: CellBlockGrid) -> CellBlockGrid:
    """Same cells/cap, half (N3L) stencil."""
    stencil, wrap = _build_stencil_half(grid.ncells)
    return dataclasses.replace(grid, stencil_cells=stencil, wrap=wrap)


def pbc_allowed(grid: CellBlockGrid, pbc: int) -> np.ndarray | None:
    """(C, S) bool: the stencil entries that cross no non-periodic
    boundary (box pbc bit i => axis i periodic, preduce.c:42-45); None
    when fully periodic."""
    if pbc & 7 == 7:
        return None
    free = np.array([not (pbc >> a) & 1 for a in range(3)])
    return ~np.any(grid.wrap.astype(bool) & free[None, None, :], axis=2)


def half_back_map(grid: CellBlockGrid) -> np.ndarray:
    """(S, ncell) int: src_map[s, t] = the cell whose direction-s block
    targets cell t (each direction is a translation, hence a bijection)."""
    src = np.zeros((grid.n_stencil, grid.ncell), dtype=np.int64)
    c = np.arange(grid.ncell)
    for s in range(grid.n_stencil):
        src[s, grid.stencil_cells[:, s]] = c
    return src


def build_cell_slots(r, fmask, box_geom, grid: CellBlockGrid):
    """Sort particles into cell-slot order; box_geom is the (3,) lengths
    or a triclinic box's (3,3) h.

    Returns (perm (ncell*cap,) int64 slot->particle with sentinel n_pad
    for empty slots, overflow flag as a device bool).  Cells fill
    rank-contiguously: the slots of cell c holding particles are exactly
    the first counts[c].  The argsort is stable, so perm equals the JAX
    package's exactly."""
    n_pad = r.shape[0]
    dev = r.device
    ncell, cap = grid.ncell, grid.cap
    s = frac_coords(r, box_geom)
    # per axis with host scalars: no host-to-device copy on the hot path
    cx, cy, cz = (torch.floor(s[:, a] * float(n)).to(torch.int64)
                  .clamp(0, n - 1) for a, n in enumerate(grid.ncells))
    ny, nz = grid.ncells[1], grid.ncells[2]
    cid = (cx * ny + cy) * nz + cz
    cid = torch.where(fmask > 0, cid, torch.full_like(cid, ncell))

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(n_pad, device=dev) - first

    ok = rank < cap
    # out-of-range writes land in a spill tail that is cut off below
    # (the JAX package's mode="drop")
    flat = torch.where(ok, sorted_cid * cap + rank,
                       torch.full_like(rank, (ncell + 1) * cap))
    perm = torch.full(((ncell + 1) * cap + 1,), n_pad, dtype=torch.int64,
                      device=dev)
    perm[flat] = order
    overflow = torch.any(~ok & (sorted_cid < ncell))
    return perm[: ncell * cap], overflow


# ---------------------------------------------------------------------------
# the plain cell-block engine
# ---------------------------------------------------------------------------

def excluded_pairs(Pe, Qe):
    """(C, P, M) bool: the pairs the exclusion channels mask, for p-side
    channels Pe (C, P, 2) and q-side Qe (C, M, 2) (run/forces.
    _excl_channels: [component id, B + 2^-(intra+1)]): the components
    match and bit intra_q of B_p is set.  Every step is exact in f32."""
    pb = torch.floor(Pe[..., 1])[:, :, None]
    qw = Qe[..., 1] - torch.floor(Qe[..., 1])
    t_bit = torch.floor(pb * (qw + qw)[:, None, :])
    bit = t_bit - 2.0 * torch.floor(t_bit * 0.5)
    return (Pe[..., 0][:, :, None] == Qe[..., 0][:, None, :]) & (bit > 0.5)


def cellpair_eval_half(r, q, tidx, perm, box_geom, grid: CellBlockGrid,
                       tables, back_map, coulomb: bool = True, allowed=None,
                       excl_vals=None):
    """Forces, energy, virial and per-particle pe of shifted LJ (+ reaction
    field) over a half-stencil grid (half_grid) in the JAX package's XLA
    cell-block formulation: each cell's slots against all 14 stencil
    blocks' slots as one (C, c, 14 c) tensor, distances as |p|^2 + |q|^2
    - 2 p.q in cell-centred coordinates, the q-side reactions folded back
    through `back_map` (half_back_map).  box_geom is (3,) lengths or a
    (3,3) h, `allowed` the pbc_allowed mask (pbc < 7).  tables: sigma,
    eps, shift (T,T) and the scalars rcut2, krf, crf, keR.

    excl_vals (n_pad, 2), the in-kernel exclusion channels, masks
    excluded pairs as the kernels do (the JAX package's cell-block engine
    computes them and subtracts them in the bonded block instead; the
    port never subtracts)."""
    n_pad = r.shape[0]
    dt = r.dtype
    dev = r.device
    ncell, cap = grid.ncell, grid.cap
    S = grid.n_stencil

    zero = torch.zeros((1,), dtype=dt, device=dev)
    r_ext = torch.cat([r, zero.expand(1, 3)])
    q_ext = torch.cat([q.to(dt), zero])
    t_ext = torch.cat([tidx, torch.zeros((1,), dtype=tidx.dtype,
                                         device=dev)])
    P = r_ext[perm].reshape(ncell, cap, 3)
    Pq = q_ext[perm].reshape(ncell, cap)
    Pt = t_ext[perm].reshape(ncell, cap)
    Pv = (perm != n_pad).reshape(ncell, cap)

    stencil = torch.as_tensor(grid.stencil_cells, dtype=torch.int64,
                              device=dev)
    shift, centers = block_geometry(grid, box_geom, dt)
    Q = P[stencil] + shift[:, :, None, :]
    P = P - centers[:, None, :]
    Q = (Q - centers[:, None, None, :]).reshape(ncell, S * cap, 3)
    Qq = Pq[stencil].reshape(ncell, S * cap)
    Qt = Pt[stencil].reshape(ncell, S * cap)
    Qv = Pv[stencil]
    if allowed is not None:
        Qv = Qv & torch.as_tensor(allowed, device=dev)[:, :, None]
    Qv = Qv.reshape(ncell, S * cap)

    # dedup only inside the self block (index 0): keep lane > row once
    rows = torch.arange(cap, device=dev)
    lanes = torch.arange(S * cap, device=dev)
    dup = (lanes[None, :] < cap) & (lanes[None, :] <= rows[:, None])

    p2 = (P * P).sum(-1)
    q2 = (Q * Q).sum(-1)
    pq = torch.einsum("ncd,nsd->ncs", P, Q)
    d2 = p2[:, :, None] + q2[:, None, :] - 2.0 * pq

    mask = (Pv[:, :, None] & Qv[:, None, :] & ~dup[None, :, :]
            & (d2 < tables["rcut2"]))
    if excl_vals is not None:
        e_ext = torch.cat([excl_vals.to(dt), zero.expand(1, 2)])
        Pe = e_ext[perm].reshape(ncell, cap, 2)
        Qe = Pe[stencil].reshape(ncell, S * cap, 2)
        mask = mask & ~excluded_pairs(Pe, Qe)
    w = mask.to(dt)

    d2s = torch.where(mask, d2, torch.ones_like(d2))
    ir2 = 1.0 / d2s
    ir = torch.sqrt(ir2)

    T = tables["sigma"].shape[0]
    if T == 1:
        sig = tables["sigma"][0, 0]
        eps = tables["eps"][0, 0]
        shf = tables["shift"][0, 0]
    else:
        pair_t = Pt[:, :, None] * T + Qt[:, None, :]
        sig = tables["sigma"].reshape(-1)[pair_t]
        eps = tables["eps"].reshape(-1)[pair_t]
        shf = tables["shift"].reshape(-1)[pair_t]

    s2 = sig * sig * ir2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e_pair = (4.0 * eps * (s12 - s6) + shf) * w
    dvdr = 24.0 * eps * (s6 - 2.0 * s12) * ir2

    if coulomb:
        kqq = tables["keR"] * Pq[:, :, None] * Qq[:, None, :]
        e_pair = e_pair + kqq * (ir + tables["krf"] * d2s - tables["crf"]) * w
        dvdr = dvdr + kqq * (2.0 * tables["krf"] - ir2 * ir)

    coef = dvdr * w
    csum = coef.sum(-1)
    CQ = torch.einsum("ncs,nsd->ncd", coef, Q)
    F_p = -P * csum[:, :, None] + CQ
    pe_p = 0.5 * e_pair.sum(-1)

    # q-side reaction: f_j = +sum_i coef_ij (p_i - q_j)
    qsum = coef.sum(1)                                        # (C, Sc)
    PC = torch.einsum("ncs,ncd->nsd", coef, P)                # (C, Sc, 3)
    F_q = PC - Q * qsum[:, :, None]
    pe_q = 0.5 * e_pair.sum(1)

    # fold the q side back through the per-direction cell permutation
    bm = torch.as_tensor(back_map, dtype=torch.int64, device=dev)
    Fq_blk = F_q.reshape(ncell, S, cap, 3)
    pq_blk = pe_q.reshape(ncell, S, cap)
    F_back = Fq_blk[bm[0], 0]
    pe_back = pq_blk[bm[0], 0]
    for s in range(1, S):
        F_back = F_back + Fq_blk[bm[s], s]
        pe_back = pe_back + pq_blk[bm[s], s]

    # each pair counted once: no 0.5
    A = torch.einsum("nc,ncd,nce->de", csum, P, P)
    B = torch.einsum("ncd,nce->de", P, CQ)
    Cm = torch.einsum("ns,nsd,nse->de", qsum, Q, Q)
    virial = -(A - B - B.T + Cm)

    F = F_p + F_back
    pe_slot = pe_p + pe_back
    # each particle owns one slot; empty slots write the spill row n_pad
    f = torch.zeros((n_pad + 1, 3), dtype=dt, device=dev)
    f[perm] = F.reshape(-1, 3)
    pe = torch.zeros((n_pad + 1,), dtype=dt, device=dev)
    pe[perm] = pe_slot.reshape(-1)
    return f[:n_pad], e_pair.sum(), virial, pe[:n_pad]
