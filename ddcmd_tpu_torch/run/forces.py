"""Force orchestration: one force function from all potentials.

Counterpart of ddcmd_tpu/run/forces.py:build_force_fn, ported for the
MARTINI nonbond term on the kernel branch (ddcenergy analog, ddcMD
src/ddcenergy.c:160-238).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.system import SystemDef
from ..ops.cellpair import half_grid
from ..ops.cellpair_half import cellpair_eval_half, grid_tensors
from ..potentials.martini import martini_device_tables


def build_force_fn(sysdef: SystemDef, grid, dtype=torch.float32):
    """Returns force_fn(state, box, perm) -> (f, e_pot, virial, pe), with
    perm the slot permutation from ops.cellpair.build_cell_slots on
    `grid` (a plan_lanes grid)."""
    state = sysdef.state
    device = state.device
    n_loc = state.n_local
    terms = []
    for ptype, _, parms in sysdef.potentials:
        if ptype != "MARTINI":
            raise NotImplementedError(f"force term {ptype}")
        tables = martini_device_tables(parms, dtype=dtype, device=device)
        tmap = torch.as_tensor(parms.species_lj_type, device=device)
        # reaction-field Coulomb is dead weight when every local charge
        # is zero (the Martini water box): skip the per-pair RF math and
        # the (zero) self energy
        coul = bool(np.any(state.q[:n_loc].cpu().numpy() != 0.0))
        # uniform-type fast path: scalar LJ parameters in the kernel
        used = np.unique(parms.species_lj_type[
            state.species[:n_loc].cpu().numpy()])
        if len(used) == 1:
            t0 = int(used[0])
            tables = dict(tables,
                          sigma=tables["sigma"][t0:t0 + 1, t0:t0 + 1],
                          eps=tables["eps"][t0:t0 + 1, t0:t0 + 1],
                          shift=tables["shift"][t0:t0 + 1, t0:t0 + 1])
            tmap = torch.zeros_like(tmap)
        hg = half_grid(grid)
        gt = grid_tensors(hg, device)

        def martini_term(state, box, perm, tables=tables, tmap=tmap,
                         hg=hg, gt=gt, coul=coul):
            tidx = tmap[state.species]
            f, e, virial, pe = cellpair_eval_half(
                state.r, state.q, tidx, perm, box.lengths, hg, tables, gt,
                coulomb=coul)
            if not coul:
                return f, e, virial, pe
            e_self_i = (-0.5 * state.q * state.q * state.fmask
                        * tables["keR"] * tables["crf"])
            return f, e + e_self_i.sum(), virial, pe + e_self_i

        terms.append(martini_term)

    def force_fn(state, box, perm):
        f = torch.zeros((state.n_pad, 3), dtype=dtype, device=device)
        pe = torch.zeros((state.n_pad,), dtype=dtype, device=device)
        virial = torch.zeros((3, 3), dtype=dtype, device=device)
        for term in terms:
            tf, _te, tv, tpe = term(state, box, perm)
            f = f + tf
            virial = virial + tv
            pe = pe + tpe
        # total energy from the per-particle sums, after all terms (as
        # the JAX package: every term keeps e == sum(pe))
        return f, pe.sum(), virial, pe

    return force_fn
