"""The port's full-stencil entry point (ops/cellpair_full, TPU kernel #3)
against the JAX package's make_pallas_cellpair + pallas_cellpair_eval
(Pallas kernel in interpret mode), and against the port's half-stencil
plain version on the same slots."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.ops.cellpair import build_cell_slots as j_build_cell_slots
from ddcmd_tpu.ops.pallas_cellpair import (make_pallas_cellpair,
                                           pack_stencil as j_pack_stencil,
                                           pallas_cellpair_eval,
                                           plan_lanes as j_plan_lanes)
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_full as tcf
from ddcmd_tpu_torch.ops import cellpair_half as tch

from tests.test_torch_cellpair import SKIN, _system

torch.set_num_threads(2)

# 3-cell axes charged and not; 1-cell axes (the wrapped self images are
# real pairs).  The half-plain comparison adds 2-cell axes, where the -1
# and +1 directions reach one cell through two images: against the
# Pallas kernel's MXU distance (|p|^2 + |q|^2 - 2 p.q) that box's close
# pairs already differ by ~2e-5 of the force scale, while both plain
# versions take p - q directly.
CASES = [(220, 4.2, False), (220, 4.2, True), (60, 2.6, True)]
HALF_CASES = CASES + [(800, 6.6, True)]


@functools.lru_cache(maxsize=None)
def _jax_full(n, L, charged):
    """The JAX package's full-stencil evaluation, Pallas in interpret
    mode (cached: each interpret-mode kernel compiles once per file)."""
    s, jt, _ = _system(n, L, charged=charged)
    jg = j_plan_lanes([L] * 3, s["rcut"], SKIN, n)
    Lv = jnp.asarray(np.full(3, L, np.float32))
    jperm, _ = j_build_cell_slots(jnp.asarray(s["r"]), jnp.asarray(s["fmask"]),
                                  Lv, jg)
    eval_fn = make_pallas_cellpair(jg, jt, coulomb=charged, interpret=True)
    res = pallas_cellpair_eval(
        jnp.asarray(s["r"]), jnp.asarray(s["q"]),
        jnp.asarray(s["t"], jnp.int32), jperm, Lv, jg, jt,
        jnp.asarray(j_pack_stencil(jg)), eval_fn)
    return tuple(np.asarray(x, np.float64) for x in res)


def _port_full(n, L, charged):
    """(grid, perm, (f, e, virial, pe)) of the port's cellpair_eval_full
    on CPU tensors, which must launch no kernel."""
    s, _, tt = _system(n, L, charged=charged)
    grid = tch.plan_lanes([L] * 3, s["rcut"], SKIN, n)
    Lv = torch.full((3,), L, dtype=torch.float32)
    perm, ov = tcp.build_cell_slots(torch.tensor(s["r"]),
                                    torch.tensor(s["fmask"]), Lv, grid)
    assert not bool(ov)
    eval_fn = tcf.make_cellpair_full(grid, tt, coulomb=charged)
    stencil = torch.as_tensor(tch.pack_stencil(grid))
    before = tcf.cellpair_full.launches
    out = tcf.cellpair_eval_full(
        torch.tensor(s["r"]), torch.tensor(s["q"]), torch.tensor(s["t"]),
        perm, Lv, grid, tt, stencil, eval_fn)
    assert tcf.cellpair_full.launches == before  # CPU: plain version only
    return grid, perm, out


@pytest.mark.parametrize("n,L,charged", CASES)
def test_eval_full_plain_matches_pallas_interpret(n, L, charged):
    """cellpair_eval_full on CPU tensors == the JAX package's
    pallas_cellpair_eval, two LJ types, at the tolerances of
    tests/test_pallas_cellpair.py:47-51."""
    grid, _, (f2, e2, v2, pe2) = _port_full(n, L, charged)
    assert grid.n_stencil == 27
    f1, e1, v1, pe1 = _jax_full(n, L, charged)
    scale = max(1.0, float(np.abs(f1).max()))
    assert float(np.abs(f2.numpy() - f1).max()) / scale < 2e-5
    assert e2.item() == pytest.approx(float(e1), rel=1e-4, abs=1e-2)
    assert v2.numpy() == pytest.approx(v1, rel=2e-3, abs=0.5)
    assert pe2.numpy() == pytest.approx(pe1, rel=1e-3, abs=1e-3)


@pytest.mark.parametrize("n,L,charged", HALF_CASES)
def test_full_plain_matches_half_plain(n, L, charged):
    """The full and half plain versions on the same packed records: the
    same physics, summed in another order (force 1e-5 of the scale)."""
    s, _, tt = _system(n, L, charged=charged)
    grid, perm, (f_full, e_full, v_full, pe_full) = _port_full(n, L, charged)
    hg = tcp.half_grid(grid)
    f, e, v, pe = tch.cellpair_eval_half(
        torch.tensor(s["r"]), torch.tensor(s["q"]), torch.tensor(s["t"]),
        perm, torch.full((3,), L, dtype=torch.float32), hg, tt,
        tch.grid_tensors(hg, "cpu"), coulomb=charged)
    scale = max(1.0, float(f.abs().max()))
    assert float((f_full - f).abs().max()) / scale < 1e-5
    assert e_full.item() == pytest.approx(e.item(), rel=1e-5, abs=1e-3)
    assert v_full.numpy() == pytest.approx(v.numpy(), rel=1e-4, abs=1e-2)
    assert pe_full.numpy() == pytest.approx(pe.numpy(), rel=1e-4, abs=1e-4)


def test_self_index_and_wrapper_checks():
    """s_self is the unwrapped (0,0,0) entry on 3-, 2- and 1-cell axes;
    the wrapper refuses a wrong dtype, layout or s_self before any kernel
    sees it, and masks the self pair only at s_self."""
    for L in (4.2, 6.6, 2.6):
        g = tch.plan_lanes([L] * 3, 1.1, SKIN, 220)
        k = tcf.self_index(g)
        assert k == 13 and (g.wrap[:, k] == 0).all()
        np.testing.assert_array_equal(g.stencil_cells[:, k],
                                      np.arange(g.ncell))
    ncell, cap = 8, 128
    slots = torch.zeros((ncell, 8, cap))
    stencil = torch.zeros((ncell, 27 * 4), dtype=torch.int32)
    L8 = torch.zeros((1, 8))
    counts = torch.zeros((ncell,), dtype=torch.int32)
    tab = torch.ones((1, 1))
    kw = dict(s_self=13, krf=0.0, crf=0.0, keR=0.0, coulomb=False)
    with pytest.raises(ValueError):
        tcf.cellpair_full(slots.double(), stencil, L8, counts, tab, tab, tab,
                          **kw)
    with pytest.raises(ValueError):
        tcf.cellpair_full(slots, stencil.long(), L8, counts, tab, tab, tab,
                          **kw)
    with pytest.raises(ValueError):
        tcf.cellpair_full(slots, stencil, L8, counts, tab, tab, tab,
                          **dict(kw, s_self=27))
    # two valid particles of cell 0 at distance 0.5: only the self
    # block's diagonal is masked, the pair itself counts from both sides
    slots[0, 5, :2] = 1.0
    slots[0, 0, 1] = 0.5
    L8[0, :3], L8[0, 3] = 1.0, 1.0
    counts[0] = 2
    sten = torch.zeros_like(stencil)
    sten[:, 1::4] = 5                       # far images everywhere ...
    sten[:, 4 * 13 + 1] = 0                 # ... but the self direction
    out_p, out_cell = tcf.cellpair_full(slots, sten, L8, counts, tab, tab,
                                        tab, **kw)
    assert out_p.shape == (ncell * cap, 4) and out_cell.shape == (ncell, 8)
    assert out_p[0, 0] == -out_p[1, 0] != 0.0
    assert out_cell[0, 0] == pytest.approx(float(out_p[:2, 3].sum()))
