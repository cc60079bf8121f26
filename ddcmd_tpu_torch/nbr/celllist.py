"""Cell list + padded (N, K) neighbor list, in plain PyTorch.

Counterpart of ddcmd_tpu/nbr/celllist.py (reference GEOM cell grid and
the GPU's fixed-size neighbor pages with an overflow check, ddcMD
src/geom.h:24-110, src/nlistGPU.cu:206,378):

  * particles are binned into a static cell grid (cell edge >= the list
    radius) by a stable sort;
  * each particle's candidates come from the 27-cell stencil (fewer on
    axes of 1 or 2 cells), in stencil order, then cell slot;
  * candidates within rcut + skin are compacted into a fixed (N, K)
    index matrix padded with the sentinel N; a cell past its capacity
    or a row past K raises the overflow flag, and the host rebuilds
    with more room;
  * the list is full: each pair appears from both sides, so a force is
    a gather and a sum, no scatter.

CellGrid.plan is host numpy, copied from the JAX package.  The list is
the JAX list in every case but one: where an axis is not periodic and
has fewer than 3 cells, the JAX list collapses that axis's stencil as
on a periodic axis, drops a reach that wraps it and then takes the
minimum image through the wall, which is wrong (an asymmetric list with
2 cells, pairs through the wall with 1).  The port keeps the full
(-1, 0, +1) reaches on a non-periodic axis (there they do not alias),
drops those that leave it, and takes the minimum image on the periodic
axes only (core/box.nearest_image_pbc), here and in every list term.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import inv3x3, nearest_image_pbc

@dataclass(frozen=True)
class CellGrid:
    """Static grid metadata (python ints: every shape is fixed per plan)."""

    ncells: tuple[int, int, int]
    cell_capacity: int
    max_neighbors: int          # K
    rlist: float                # rcut + skin, internal units

    @property
    def ncell_total(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @classmethod
    def plan(cls, box_lengths, rcut: float, skin: float, n_particles: int,
             n_pad: int, density_safety: float = 2.0,
             max_neighbors: int | None = None,
             plan_margin: float = 1.0, positions=None,
             occupancy_factor: float = 1.0) -> "CellGrid":
        """positions (optional): measure the real peak cell occupancy and
        raise capacities above the mean-density estimate (inhomogeneous
        systems bust it); occupancy_factor scales the measured peak."""
        L = np.asarray(box_lengths, dtype=np.float64)
        rlist = rcut + skin
        ncells = tuple(max(1, int(math.floor(l / (rlist * plan_margin))))
                       for l in L)
        vol = float(np.prod(L))
        density = n_particles / vol
        cell_vol = vol / (ncells[0] * ncells[1] * ncells[2])
        cap = int(density * cell_vol * density_safety) + 8
        cap = ((cap + 7) // 8) * 8
        if max_neighbors is None:
            nsphere = density * 4.0 / 3.0 * math.pi * rlist ** 3 * 1.6
            max_neighbors = ((int(nsphere) + 127) // 128) * 128
        if positions is not None and len(positions):
            p = np.asarray(positions, dtype=np.float64)
            nc = np.asarray(ncells)
            c = np.floor((p / L + 0.5 - np.floor(p / L + 0.5)) * nc)
            c = np.clip(c.astype(np.int64), 0, nc - 1)
            lin = (c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2]
            occ = int(np.bincount(lin, minlength=int(np.prod(nc))).max())
            meas = int(occ * occupancy_factor * 1.5) + 8
            cap = max(cap, ((meas + 7) // 8) * 8)
            peak_density = occ / cell_vol
            nsph = (peak_density * 4.0 / 3.0 * math.pi * rlist ** 3
                    * 1.6 * occupancy_factor)
            max_neighbors = max(max_neighbors,
                                ((int(nsph) + 127) // 128) * 128)
        return cls(ncells=ncells, cell_capacity=cap,
                   max_neighbors=max_neighbors, rlist=rlist)


def _cell_index(r, geom, ncells):
    """(N, 3) int64 cell coordinates of origin-centred positions;
    triclinic boxes bin in fractional coordinates (GEOM non-orthorhombic
    binning, src/geom.c)."""
    n = torch.tensor(ncells, device=r.device)
    if geom.dim() == 1:
        s = r / geom + 0.5                           # [0, 1)
    else:
        s = r @ inv3x3(geom).T + 0.5
    c = torch.floor(s * n).long()
    return torch.minimum(torch.clamp(c, min=0), n - 1)


def _flat_cell(c3, ncells):
    nx, ny, nz = ncells
    return (c3[..., 0] * ny + c3[..., 1]) * nz + c3[..., 2]


def _stencil_for(ncells, pbc: int = 7) -> np.ndarray:
    """Unique neighbor-cell offsets.  On a periodic axis of fewer than 3
    cells the -1 and +1 offsets alias under the wrap and would count a
    pair twice, so they collapse.  A non-periodic axis keeps all three:
    there a reach that leaves the axis is dropped (build_neighbor_list)
    and the others do not alias."""
    axes = []
    for a, n in enumerate(ncells):
        if n >= 3 or not (pbc >> a) & 1:
            axes.append((-1, 0, 1))
        elif n == 2:
            axes.append((0, 1))
        else:
            axes.append((0,))
    return np.array([(i, j, k) for i in axes[0] for j in axes[1]
                     for k in axes[2]], dtype=np.int32)


def build_cell_table(r, fmask, geom, grid: CellGrid):
    """Bin particles.  Returns (table (ncell_total + 1, cap) int64
    particle ids padded with the sentinel n_pad, the last row the trash
    cell of masked particles; cell3 (N, 3) cell coords; overflow flag)."""
    n_pad = r.shape[0]
    dev = r.device
    c3 = _cell_index(r, geom, grid.ncells)
    cid = _flat_cell(c3, grid.ncells)
    # masked (padding) particles go to the trash cell
    cid = torch.where(fmask > 0, cid, grid.ncell_total)
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    # rank within the cell: position minus the cell's first occurrence
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(n_pad, device=dev) - first
    cap = grid.cell_capacity
    trash = (grid.ncell_total + 1) * cap     # one slot past the table
    ok = rank < cap
    flat = torch.where(ok, sorted_cid * cap + rank, trash)
    table = torch.full((trash + 1,), n_pad, dtype=torch.int64, device=dev)
    table[flat] = order
    overflow = torch.any(~ok & (sorted_cid < grid.ncell_total))
    return table[:trash].reshape(grid.ncell_total + 1, cap), c3, overflow


def build_neighbor_list(r, fmask, geom, grid: CellGrid, row_mask=None,
                        pbc: int = 7, n_rows: int | None = None):
    """Full (N, K) neighbor index list within rlist.  Returns (nbr_idx
    (N, K) int64 padded with the sentinel n_pad, nbr_count (N,) int32,
    overflow flag).  Positions must be wrapped (origin-centred).

    fmask: particles that may appear as neighbors (binned into cells).
    row_mask: particles whose own rows are built (defaults to fmask).
    pbc: box periodicity bits (bit i => axis i periodic); stencil reaches
    that leave a non-periodic axis are dropped, and distances take the
    minimum image on the periodic axes only.
    n_rows: build the rows of the first n_rows particles only (the others
    are neighbours only), returning (n_rows, K) and (n_rows,); the
    sentinel stays N.  The brick list engine builds its local rows
    against local and ghost particles this way."""
    n_pad = r.shape[0]
    n_rows = n_pad if n_rows is None else n_rows
    sentinel = n_pad
    dev = r.device
    if row_mask is None:
        row_mask = fmask
    table, c3, cell_overflow = build_cell_table(r, fmask, geom, grid)

    cap = grid.cell_capacity
    ncells = torch.tensor(grid.ncells, device=dev)
    stencil = torch.as_tensor(_stencil_for(grid.ncells, pbc),
                              device=dev).long()
    n_stencil = stencil.shape[0]
    # (N, S, 3) neighbor cell coords with the periodic wrap
    raw = c3[:n_rows, None, :] + stencil[None, :, :]
    ncid = _flat_cell(raw % ncells, grid.ncells)          # (N, S)
    cand = table[ncid].reshape(n_rows, n_stencil * cap)   # (N, C)
    pbc_ok = mask = None
    if pbc & 7 != 7:
        free = torch.tensor([not (pbc >> a) & 1 for a in range(3)],
                            device=dev)
        crossed = torch.any(((raw < 0) | (raw >= ncells)) & free, dim=-1)
        pbc_ok = ~torch.repeat_interleave(crossed, cap, dim=1)
        mask = (~free).to(r.dtype)
    del raw, ncid

    # distances (minimum image).  Orthorhombic boxes compute them per
    # component, as the JAX list does (no (N, C, 3) intermediate)
    r_ext = torch.cat([r, r.new_zeros((1, 3))], dim=0)
    ri = r[:n_rows]
    if geom.dim() == 1:
        d2 = torch.zeros(cand.shape, dtype=r.dtype, device=dev)
        for c in range(3):
            dc = nearest_image_pbc(
                ri[:, c][:, None] - r_ext[:, c][cand], geom[c:c + 1],
                None if mask is None else mask[c:c + 1])
            d2 = d2 + dc * dc
        del dc
    else:
        dr = nearest_image_pbc(ri[:, None, :] - r_ext[cand], geom, mask)
        d2 = torch.sum(dr * dr, dim=-1)
        del dr

    i_idx = torch.arange(n_rows, device=dev)[:, None]
    valid = ((cand != sentinel) & (cand != i_idx) & (d2 < grid.rlist ** 2)
             & (row_mask[:n_rows, None] > 0))
    del d2
    if pbc_ok is not None:
        valid = valid & pbc_ok

    K = grid.max_neighbors
    pos = torch.cumsum(valid, dim=1, dtype=torch.int32) - 1
    count = (pos[:, -1] + 1 if valid.shape[1] > 0
             else torch.zeros(n_rows, dtype=torch.int32, device=dev))
    # column K is the trash of invalid and past-K candidates
    slot = torch.where(valid & (pos < K), pos, K).long()
    del pos, valid
    out = torch.full((n_rows, K + 1), sentinel, dtype=torch.int64,
                     device=dev)
    out.scatter_(1, slot, cand)
    overflow = cell_overflow | torch.any(count > K)
    return out[:, :K], count, overflow


def neighbor_displacements(r, nbr_idx, geom, pbc_mask=None):
    """dr_ij = r_i - r_j with the minimum image on the periodic axes
    (pbc_mask: Box.pbc_mask, None when fully periodic), (N, K, 3), and
    the valid mask (N, K)."""
    sentinel = r.shape[0]
    r_ext = torch.cat([r, r.new_zeros((1, 3))], dim=0)
    dr = nearest_image_pbc(r[:, None, :] - r_ext[nbr_idx], geom, pbc_mask)
    return dr, nbr_idx != sentinel


def max_displacement2(r, r0, fmask, geom, pbc_mask=None):
    """max_i |r_i - r_i0|^2, the verlet-skin rebuild trigger
    (neighborCheck, ddcMD src/neighbor.c:117-199)."""
    dr = nearest_image_pbc(r - r0, geom, pbc_mask)
    return torch.max(torch.sum(dr * dr, dim=-1) * fmask)
