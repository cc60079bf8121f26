"""Full-stencil cell-pair engine: the kernel and its entry point.

Counterpart of the full-stencil part of ddcmd_tpu/ops/pallas_cellpair.py:
`make_pallas_cellpair` (TPU kernel #3, `_kernel`) and its one public
entry point `pallas_cellpair_eval`, a drop-in replacement for the
cell-block engine's `cellpair_eval`.  Every cell sums over all 27
neighbour blocks and writes only its own particles' forces (no Newton's
third law, no q side), at the price of meeting every pair twice, once
from each of its cells.  No simulate path runs it: the main paths take
the half-stencil kernels of ops/cellpair_half.py.

  cellpair_full / cellpair_full_plain   kernel (csrc/cellpair_half.cu:
                                        ddcmd_cellpair_full) and its
                                        plain PyTorch version
  make_cellpair_full                    <- make_pallas_cellpair
  cellpair_eval_full                    <- pallas_cellpair_eval

The kernel is the half-stencil kernels' CTA (csrc/sweep.cuh's pruned
two-phase sweep) over the 27 directions with a hit evaluator that adds
only the p side (csrc/pair_hit.cuh, kQSide = false): the self block keeps
every j != i, the other directions are box-pruned as for the half
stencil, the CTA stages no q-side blocks and halves its [e, virial6].
What bounds it on an H100 is what bounds the half stencil -- the distance
tests the pruning leaves and phase 2's shared-memory float atomics --
with twice the hits and half the atomics a hit.  Its sums are atomic and
unordered, so results are not deterministic from run to run (the TPU
kernel's determinism is its sequential grid's): every comparison states a
tolerance.

The grid is a plan_lanes grid with its full 27-direction stencil
(ops/cellpair._build_stencil) and pack_stencil's table; slots are
pack_slots' records.  On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .cellpair import CellBlockGrid
from .cellpair_half import (PAIR_CELL_THREADS, SMEM_LIMIT, _check,
                            _check_common, _kernel_fn, frac_centers,
                            pack_slots, sweep_smem_bytes)


def full_smem_bytes(cap: int, T: int) -> int:
    """The least dynamic shared memory the full-stencil kernel launches
    with (csrc/cellpair_half.cu:ddcmd_cellpair_full): one direction a CTA,
    the charge as the one extra row, 4 accumulator rows, no q-side blocks.
    The launch takes more directions a CTA while they fit its budget."""
    return sweep_smem_bytes(cap, 1, 0, 3 * T * T, 1, 4, PAIR_CELL_THREADS)


def self_index(grid: CellBlockGrid) -> int:
    """Stencil index of the (0,0,0) direction, the same for every cell:
    the entry of cell 0 that reaches cell 0 with no image wrap."""
    wrap0 = np.all(grid.wrap[0] == 0, axis=-1)
    return int(np.nonzero((grid.stencil_cells[0] == 0) & wrap0)[0][0])


def cellpair_full_plain(slots, stencil, L8, counts, sigma, eps, shift, *,
                        s_self: int, krf: float, crf: float, keR: float,
                        coulomb: bool):
    """Plain PyTorch version of the full-stencil kernel (same contract
    and outputs).  Loops over the stencil blocks so memory stays at
    (ncell, cap, cap) per block.  `counts` is not needed: empty slots
    carry valid = 0."""
    del counts
    ncell, _, cap = slots.shape
    S = stencil.shape[1] // 4
    T = sigma.shape[0]
    dt = slots.dtype
    dev = slots.device
    L8 = L8.reshape(-1)
    rcut2 = L8[3]
    px, py, pz = slots[:, 0, :, None], slots[:, 1, :, None], slots[:, 2, :, None]
    pq, pv = slots[:, 3, :, None], slots[:, 5, :, None]
    pt = slots[:, 4].long()
    diag = torch.eye(cap, dtype=torch.bool, device=dev)
    out_p = torch.zeros((ncell, cap, 4), dtype=dt, device=dev)
    out_cell = torch.zeros((ncell, 8), dtype=dt, device=dev)
    for s in range(S):
        tgt = stencil[:, 4 * s].long()
        sh = stencil[:, 4 * s + 1:4 * s + 4].to(dt) * L8[0:3]  # (C,3)
        Q = slots[tgt]                                         # (C,8,cap)
        dx = px - (Q[:, 0] + sh[:, 0:1])[:, None, :]           # (C,cap,cap)
        dy = py - (Q[:, 1] + sh[:, 1:2])[:, None, :]
        dz = pz - (Q[:, 2] + sh[:, 2:3])[:, None, :]
        d2 = dx * dx + dy * dy + dz * dz
        valid = (pv * Q[:, 5, None, :] > 0) & (d2 < rcut2)
        if s == s_self:
            valid = valid & ~diag
        w = valid.to(dt)
        d2s = torch.where(valid, d2, torch.ones_like(d2))
        ir2 = 1.0 / d2s
        if T == 1:
            sig, ep, shf = sigma[0, 0], eps[0, 0], shift[0, 0]
        else:
            qt = Q[:, 4].long()
            sig = sigma[pt[:, :, None], qt[:, None, :]]
            ep = eps[pt[:, :, None], qt[:, None, :]]
            shf = shift[pt[:, :, None], qt[:, None, :]]
        s2 = sig * sig * ir2
        s6 = s2 * s2 * s2
        s12 = s6 * s6
        e_pair = (4.0 * ep * (s12 - s6) + shf) * w
        dvdr = 24.0 * ep * (s6 - 2.0 * s12) * ir2
        if coulomb:
            ir = torch.rsqrt(d2s)
            kqq = keR * pq * Q[:, 3, None, :]
            e_pair = e_pair + kqq * (ir + krf * d2s - crf) * w
            dvdr = dvdr + kqq * (2.0 * krf - ir2 * ir)
        coef = dvdr * w
        fdx, fdy, fdz = coef * dx, coef * dy, coef * dz
        out_p += torch.stack([-fdx.sum(2), -fdy.sum(2), -fdz.sum(2),
                              0.5 * e_pair.sum(2)], dim=2)
        out_cell[:, :7] += 0.5 * torch.stack([
            e_pair.sum((1, 2)),
            -(fdx * dx).sum((1, 2)), -(fdy * dy).sum((1, 2)),
            -(fdz * dz).sum((1, 2)), -(fdx * dy).sum((1, 2)),
            -(fdx * dz).sum((1, 2)), -(fdy * dz).sum((1, 2))], dim=1)
    return out_p.reshape(ncell * cap, 4), out_cell


def cellpair_full(slots, stencil, L8, counts, sigma, eps, shift, *,
                  s_self: int, krf: float, crf: float, keR: float,
                  coulomb: bool):
    """Full 27-stencil pair sweep, one CTA per (cell, group of
    directions) (contract in csrc/cellpair_half.cu:ddcmd_cellpair_full);
    `s_self` is the stencil index of the (0,0,0) direction, where the self
    pair is masked.

    Returns (per-slot (ncell*cap, 4) [f, pe], per-cell (ncell, 8) [e,
    virial6]).  A CPU tensor runs cellpair_full_plain; a CUDA tensor
    launches the kernel (counted in `cellpair_full.launches`) or
    raises."""
    ncell, cap, T = _check_common(slots, L8, counts, sigma, eps, shift)
    if stencil.dim() != 2 or stencil.shape[1] % 4:
        raise ValueError("stencil must be (ncell, S*4)")
    _check({"stencil": (stencil, torch.int32, (ncell, stencil.shape[1]))},
           slots.device)
    S = stencil.shape[1] // 4
    if not 0 <= s_self < S:
        raise ValueError(f"s_self={s_self} outside the {S} stencil entries")
    kw = dict(s_self=s_self, krf=krf, crf=crf, keR=keR, coulomb=coulomb)
    if slots.device.type == "cpu":
        return cellpair_full_plain(slots, stencil, L8, counts, sigma, eps,
                                   shift, **kw)
    if full_smem_bytes(cap, T) > SMEM_LIMIT:
        raise ValueError(f"T={T} tables do not fit in shared memory at cap={cap}")
    fn = _kernel_fn("cellpair_full", "cellpair_half")
    # zeroed: the kernel adds into them where a cell's directions are split
    out_p = torch.zeros((ncell * cap, 4), dtype=torch.float32,
                        device=slots.device)
    out_cell = torch.zeros((ncell, 8), dtype=torch.float32,
                           device=slots.device)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slots.data_ptr(), stencil.data_ptr(), L8.data_ptr(),
                 counts.data_ptr(), sigma.data_ptr(), eps.data_ptr(),
                 shift.data_ptr(), out_p.data_ptr(), out_cell.data_ptr(),
                 ncell, cap, S, s_self, T, krf, crf, keR,
                 int(bool(coulomb)), stream)
    if err != 0:
        raise RuntimeError(f"cellpair_full launch failed: CUDA error {err}")
    cellpair_full.launches += 1
    return out_p, out_cell


cellpair_full.launches = 0


def make_cellpair_full(grid: CellBlockGrid, tables, coulomb: bool = True):
    """Counterpart of make_pallas_cellpair: returns eval_fn(slots,
    stencil, L8, counts) -> (per-slot (ncell*cap, 4) [f, pe], per-cell
    (ncell, 8) [e, virial6]) over `grid`'s full stencil.  `tables` is
    either package's martini_device_tables output (arrays or tensors);
    the parameter tables go to the device of `tables["sigma"]` (the CPU
    for numpy)."""
    if grid.cap % 32:
        raise ValueError("the full-stencil kernel needs a 32-multiple cap")
    dev = (tables["sigma"].device if torch.is_tensor(tables["sigma"])
           else torch.device("cpu"))
    tabs = [torch.as_tensor(tables[k], dtype=torch.float32,
                            device=dev).contiguous()
            for k in ("sigma", "eps", "shift")]
    kw = dict(s_self=self_index(grid), krf=float(tables.get("krf", 0.0)),
              crf=float(tables.get("crf", 0.0)),
              keR=float(tables.get("keR", 0.0)), coulomb=coulomb)

    def eval_fn(slots, stencil, L8, counts):
        return cellpair_full(slots, stencil, L8, counts, *tabs, **kw)

    eval_fn.tabs, eval_fn.kw = tabs, kw
    return eval_fn


def cellpair_eval_full(r, q, tidx, perm, box_lengths, grid: CellBlockGrid,
                       tables, stencil, eval_fn):
    """Counterpart of pallas_cellpair_eval (a drop-in for the cell-block
    engine's cellpair_eval): pack the slots, sweep every cell's full
    stencil, scatter the per-slot results back to particles by `perm`,
    sum e and the virial.  stencil: pack_stencil(grid) as an int32
    tensor on r's device; eval_fn from make_cellpair_full.  Returns (f
    (n_pad, 3), e, virial (3, 3), pe (n_pad,))."""
    n_pad = r.shape[0]
    dev = r.device
    ncell, cap = grid.ncell, grid.cap
    box_lengths = box_lengths.to(torch.float32)
    slots, _ = pack_slots(r, q, tidx, perm, box_lengths, grid,
                          torch.as_tensor(frac_centers(grid), device=dev))
    ncells = torch.tensor(grid.ncells, dtype=torch.float32, device=dev)
    L8 = torch.nn.functional.pad(box_lengths / ncells, (0, 5))
    L8[3] = float(tables["rcut2"])
    # slots fill rank-contiguously: the filled count bounds both loops
    counts = (perm.reshape(ncell, cap) != n_pad).sum(dim=1, dtype=torch.int32)
    out_p, out_cells = eval_fn(slots, stencil, L8.reshape(1, 8), counts)
    f = torch.zeros((n_pad + 1, 3), dtype=torch.float32, device=dev)
    f[perm] = out_p[:, 0:3]
    pe = torch.zeros((n_pad + 1,), dtype=torch.float32, device=dev)
    pe[perm] = out_p[:, 3]
    e = out_cells[:, 0].sum()
    v6 = out_cells[:, 1:7].sum(dim=0)
    virial = torch.stack([v6[0], v6[3], v6[4],
                          v6[3], v6[1], v6[5],
                          v6[4], v6[5], v6[2]]).reshape(3, 3)
    return f[:n_pad], e, virial, pe[:n_pad]
