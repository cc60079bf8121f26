"""The plain cell-block EAM engine: the two-pass embedded-atom
evaluation on the half-stencil cell blocks of the plain pair engine
(ops/cellpair.py), in plain PyTorch.

Counterpart of ddcmd_tpu/ops/cellpair_eam.py:eam_cellblock_eval_half,
the JAX package's XLA engine for every EAM deck its kernels do not take:
the TABULAR form without a refit (linear-interpolated lookups), more
than 4 species, a triclinic box and f64.  Pass 1 accumulates densities and pair
energies on both sides of each (cell, slot, stencil slot) pair, the q
side folded back through the half stencil's back map; the embedding F,
dF is evaluated per slot; pass 2 sweeps the same blocks with
coef = dphi + dF_p drho(t_p, t_q) + dF_q drho(t_q, t_p), the
asymmetric-alloy combine of eam.c:166-190.  Every form of
potentials/eam.py (_pair_eval, _embedding), any dtype, (3,) lengths or a
(3,3) h.  It launches no hand-written kernel (in the JAX package it
reaches no Pallas kernel either), and its (ncell, cap, 14 cap)
intermediates, a dozen or more alive in each pass, size it for small and
mid-size decks.

On a box with a non-periodic axis it takes the pair engine's stencil
mask (`allowed`, ops/cellpair.pbc_allowed): a (cell, direction) block
that crosses a wall adds nothing to either side's density in pass 1 and
no force in pass 2, so the embedding derivative of an atom near the wall
comes from its reduced density.  The JAX engine takes no mask and feels
pairs through the wall.
"""

from __future__ import annotations

import torch

from ..potentials.eam import _embedding, _pair_eval
from .cellpair import CellBlockGrid, block_geometry


def eam_cellblock_eval_half(r, sidx, fmask, perm, box_geom,
                            grid: CellBlockGrid, tables, back_map,
                            allowed=None):
    """Forces, energy, virial and per-particle pe of the EAM term on a
    half-stencil grid (half_grid).  perm from build_cell_slots, back_map
    from half_back_map, tables from eam_device_tables, box_geom (3,)
    lengths or a (3,3) h, `allowed` the pbc_allowed mask (pbc < 7)."""
    n_pad = r.shape[0]
    dt = r.dtype
    dev = r.device
    ncell, cap = grid.ncell, grid.cap
    S = grid.n_stencil
    T = tables["n_species"]
    form = tables["form"]

    zero = torch.zeros((1,), dtype=dt, device=dev)
    r_ext = torch.cat([r, zero.expand(1, 3)])
    s_ext = torch.cat([sidx, torch.zeros((1,), dtype=sidx.dtype,
                                         device=dev)])
    f_ext = torch.cat([fmask.to(dt), zero])
    P = r_ext[perm].reshape(ncell, cap, 3)
    Pt = s_ext[perm].reshape(ncell, cap)
    Pv = ((perm != n_pad) & (f_ext[perm] > 0)).reshape(ncell, cap)

    stencil = torch.as_tensor(grid.stencil_cells, dtype=torch.int64,
                              device=dev)
    shift, centers = block_geometry(grid, box_geom, dt)
    Q = P[stencil] + shift[:, :, None, :]
    # cell-centred coordinates (f32 cancellation of |p|^2 + |q|^2 - 2 p.q)
    Pc = P - centers[:, None, :]
    Q = (Q - centers[:, None, None, :]).reshape(ncell, S * cap, 3)
    Qt = Pt[stencil].reshape(ncell, S * cap)
    Qv = Pv[stencil]
    if allowed is not None:
        # one mask on the pair weight w drops both sides of a block
        Qv = Qv & torch.as_tensor(allowed, device=dev)[:, :, None]
    Qv = Qv.reshape(ncell, S * cap)

    # dedup only inside the self block (index 0): keep lane > row once
    rows = torch.arange(cap, device=dev)
    lanes = torch.arange(S * cap, device=dev)
    dup = (lanes[None, :] < cap) & (lanes[None, :] <= rows[:, None])

    p2 = (Pc * Pc).sum(-1)
    q2 = (Q * Q).sum(-1)
    d2 = p2[:, :, None] + q2[:, None, :] - 2.0 * torch.einsum(
        "ncd,nsd->ncs", Pc, Q)
    mask = (Pv[:, :, None] & Qv[:, None, :] & ~dup[None, :, :]
            & (d2 < tables["rcut2"]) & (d2 > 0))
    del p2, q2
    w = mask.to(dt)
    d2s = torch.where(mask, d2, torch.ones_like(d2))
    del d2, mask
    ir2 = 1.0 / d2s
    ir = torch.sqrt(ir2)

    pair_idx = Pt[:, :, None] * T + Qt[:, None, :]
    pair_idx_T = Qt[:, None, :] * T + Pt[:, :, None] if T > 1 else None
    bm = torch.as_tensor(back_map, dtype=torch.int64, device=dev)

    def fold(blk):        # (C, S, cap, ...) -> (C, cap, ...) via back map
        out = blk[bm[0], 0]
        for s in range(1, S):
            out = out + blk[bm[s], s]
        return out

    # pass 1: densities and pair energy, both sides; the q side receives
    # rho(t_q, t_p)
    e1, p1 = _pair_eval(form, tables["pair"], pair_idx, d2s, ir, ir2, False)
    if T == 1:
        p1T = p1
    else:
        _, p1T = _pair_eval(form, tables["pair"], pair_idx_T, d2s, ir, ir2,
                            False)
    e1 = e1 * w
    rho_slot = (p1 * w).sum(-1) + fold((p1T * w).sum(1).reshape(ncell, S,
                                                                 cap))
    del p1, p1T
    pe_pair = 0.5 * e1.sum(-1) + fold((0.5 * e1.sum(1)).reshape(ncell, S,
                                                                 cap))
    del e1

    F_slot, dF_slot = _embedding(form, tables["embed"], Pt, rho_slot)
    wv = Pv.to(dt)
    F_slot = F_slot * wv
    dF_slot = dF_slot * wv

    # pass 2: dF blocked over the half stencil like the positions
    dFq = dF_slot[stencil].reshape(ncell, S * cap)
    de, dp = _pair_eval(form, tables["pair"], pair_idx, d2s, ir, ir2, True)
    if T == 1:
        dpT = dp
    else:
        _, dpT = _pair_eval(form, tables["pair"], pair_idx_T, d2s, ir, ir2,
                            True)
    coef = (de + dF_slot[:, :, None] * dp + dFq[:, None, :] * dpT) * w
    del de, dp, dpT, w

    csum = coef.sum(-1)
    CQ = torch.einsum("ncs,nsd->ncd", coef, Q)
    F_p = -Pc * csum[:, :, None] + CQ
    qsum = coef.sum(1)
    PC = torch.einsum("ncs,ncd->nsd", coef, Pc)
    F_q = PC - Q * qsum[:, :, None]
    F_back = fold(F_q.reshape(ncell, S, cap, 3))

    # each pair counted once: no 0.5
    A = torch.einsum("nc,ncd,nce->de", csum, Pc, Pc)
    B = torch.einsum("ncd,nce->de", Pc, CQ)
    Cm = torch.einsum("ns,nsd,nse->de", qsum, Q, Q)
    virial = -(A - B - B.T + Cm)

    pe_slot = pe_pair + F_slot
    Ftot = F_p + F_back
    # each particle owns one slot; empty slots write the spill row n_pad
    f = torch.zeros((n_pad + 1, 3), dtype=dt, device=dev)
    f[perm] = Ftot.reshape(-1, 3)
    pe = torch.zeros((n_pad + 1,), dtype=dt, device=dev)
    pe[perm] = pe_slot.reshape(-1)
    return f[:n_pad], pe_slot.sum(), virial, pe[:n_pad]
