"""Cell-block grid, stencils and sort-based binning.

Counterpart of ddcmd_tpu/ops/cellpair.py (grid, stencil and rebuild
parts).  At each rebuild particles are binned into a static cell grid
(edge >= rcut + skin), stably argsorted into slot order, and the
slot->particle permutation is kept; the pair kernel then sweeps every
slot pair of a cell against its half stencil.  Minimum image is replaced
by per-(cell, stencil-direction) integer image wraps, exact for every pair
within the cutoff because the cell edge >= rlist -- which requires
positions to stay unwrapped between rebuilds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


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

    def with_cap(self, cap: int) -> "CellBlockGrid":
        return dataclasses.replace(self, cap=cap)


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


def build_cell_slots(r, fmask, box_lengths, grid: CellBlockGrid):
    """Sort particles into cell-slot order (orthorhombic box).

    Returns (perm (ncell*cap,) int64 slot->particle with sentinel n_pad
    for empty slots, overflow flag as a device bool).  Cells fill
    rank-contiguously: the slots of cell c holding particles are exactly
    the first counts[c].  The argsort is stable, so perm equals the JAX
    package's exactly."""
    n_pad = r.shape[0]
    dev = r.device
    ncell, cap = grid.ncell, grid.cap
    s = r / box_lengths + 0.5
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
