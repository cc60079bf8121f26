"""The port's cell plan, binning, slot packing and pair-kernel twin
against the JAX package (Pallas half kernel in interpret mode)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.ops.cellpair import build_cell_slots as j_build_cell_slots
from ddcmd_tpu.ops.cellpair import half_grid as j_half_grid
from ddcmd_tpu.ops.pallas_cellpair import (make_pallas_cellpair_half,
                                           pack_slots as j_pack_slots,
                                           pack_stencil as j_pack_stencil,
                                           pallas_cellpair_eval_half,
                                           plan_lanes as j_plan_lanes)
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_half as tch

from tests.test_nbr_martini import make_system

torch.set_num_threads(2)

GEOMETRIES = [(220, 4.2), (800, 6.6), (60, 2.6)]   # 3-, 2- and 1-cell axes
SKIN = 0.3


def _system(n, L, charged, seed=11):
    """Padded inputs from numpy, as (numpy dict, jax tables, torch tables)."""
    r, q, tidx, sigma, eps, shift, rcut, krf, crf, keR = make_system(
        n=n, L=L, seed=seed, charged=charged)
    n_pad = ((n + 127) // 128) * 128
    rp = np.zeros((n_pad, 3), np.float32)
    rp[:n] = r
    qp = np.zeros(n_pad, np.float32)
    qp[:n] = q
    tp = np.zeros(n_pad, np.int64)
    tp[:n] = tidx
    fmask = (np.arange(n_pad) < n).astype(np.float32)
    jt = dict(sigma=jnp.asarray(sigma, jnp.float32),
              eps=jnp.asarray(eps, jnp.float32),
              shift=jnp.asarray(shift, jnp.float32),
              rcut2=jnp.asarray(rcut ** 2, jnp.float32),
              krf=jnp.asarray(krf, jnp.float32),
              crf=jnp.asarray(crf, jnp.float32),
              keR=jnp.asarray(keR, jnp.float32))
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    tt = dict(sigma=torch.tensor(sigma, dtype=torch.float32),
              eps=torch.tensor(eps, dtype=torch.float32),
              shift=torch.tensor(shift, dtype=torch.float32),
              rcut2=f32(rcut ** 2), krf=f32(krf), crf=f32(crf), keR=f32(keR))
    return dict(r=rp, q=qp, t=tp, fmask=fmask, rcut=rcut, L=L, n=n), jt, tt


def _grids(s):
    jg = j_plan_lanes([s["L"]] * 3, s["rcut"], SKIN, s["n"])
    tg = tch.plan_lanes([s["L"]] * 3, s["rcut"], SKIN, s["n"])
    return jg, tg


@pytest.mark.parametrize("n,L", GEOMETRIES)
def test_plan_and_stencils_equal_jax(n, L):
    s, _, _ = _system(n, L, charged=True)
    jg, tg = _grids(s)
    assert (tg.ncells, tg.cap, tg.rlist) == (jg.ncells, jg.cap, jg.rlist)
    np.testing.assert_array_equal(tg.stencil_cells, jg.stencil_cells)
    np.testing.assert_array_equal(tg.wrap, jg.wrap)
    jh, th = j_half_grid(jg), tcp.half_grid(tg)
    assert th.n_stencil == 14
    np.testing.assert_array_equal(th.stencil_cells, jh.stencil_cells)
    np.testing.assert_array_equal(th.wrap, jh.wrap)
    np.testing.assert_array_equal(tch.pack_stencil(th), j_pack_stencil(jh))


@pytest.mark.parametrize("density_safety", [1.3, 1.3 ** 3])
def test_replanned_grid_equals_jax(density_safety):
    """The overflow ladder's replans (density safety grown by 1.3) plan
    the same grids in both packages."""
    L = np.array([9.38, 9.38, 9.38])
    jg = j_plan_lanes(L, 1.1, 0.4, 6173, density_safety=density_safety)
    tg = tch.plan_lanes(L, 1.1, 0.4, 6173, density_safety=density_safety)
    assert (tg.ncells, tg.cap) == (jg.ncells, jg.cap)


@pytest.mark.parametrize("n,L", GEOMETRIES)
def test_binning_and_slots_equal_jax(n, L):
    s, _, _ = _system(n, L, charged=True)
    jg, tg = _grids(s)
    Lv = np.full(3, L, np.float32)
    jperm, jov = j_build_cell_slots(jnp.asarray(s["r"]),
                                    jnp.asarray(s["fmask"]),
                                    jnp.asarray(Lv), jg)
    tperm, tov = tcp.build_cell_slots(torch.tensor(s["r"]),
                                      torch.tensor(s["fmask"]),
                                      torch.tensor(Lv), tg)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    assert bool(tov) == bool(jov) is False

    jslots, jcent = j_pack_slots(jnp.asarray(s["r"]), jnp.asarray(s["q"]),
                                 jnp.asarray(s["t"], jnp.int32), jperm,
                                 jnp.asarray(Lv), j_half_grid(jg))
    th = tcp.half_grid(tg)
    gt = tch.grid_tensors(th, "cpu")
    tslots, tcent = tch.pack_slots(torch.tensor(s["r"]), torch.tensor(s["q"]),
                                   torch.tensor(s["t"]), tperm,
                                   torch.tensor(Lv), th, gt["frac_centers"])
    np.testing.assert_array_equal(tcent.numpy(), np.asarray(jcent))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))


def test_binning_flags_overflow_like_jax():
    """A cap too small for the occupancy raises the overflow flag and
    drops the same particles in both packages."""
    s, _, _ = _system(220, 4.2, charged=False)
    jg, tg = _grids(s)
    jg, tg = jg.with_cap(16), tg.with_cap(16)
    Lv = np.full(3, 4.2, np.float32)
    jperm, jov = j_build_cell_slots(jnp.asarray(s["r"]),
                                    jnp.asarray(s["fmask"]),
                                    jnp.asarray(Lv), jg)
    tperm, tov = tcp.build_cell_slots(torch.tensor(s["r"]),
                                      torch.tensor(s["fmask"]),
                                      torch.tensor(Lv), tg)
    assert bool(jov) and bool(tov)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))


def _assert_close(f1, e1, v1, pe1, f2, e2, v2, pe2):
    """The tolerances of tests/test_pallas_cellpair.py (half kernel)."""
    f1, v1, pe1 = (np.asarray(x, np.float64) for x in (f1, v1, pe1))
    scale = max(1.0, float(np.abs(f1).max()))
    assert float(np.abs(np.asarray(f2) - f1).max()) / scale < 2e-5
    assert float(e2) == pytest.approx(float(e1), rel=1e-4, abs=1e-2)
    assert np.asarray(v2) == pytest.approx(v1, rel=2e-3, abs=0.5)
    assert np.asarray(pe2) == pytest.approx(pe1, rel=1e-3, abs=2e-3)


@functools.lru_cache(maxsize=None)
def _jax_half(n, L, charged):
    """The JAX package's pallas_cellpair_eval_half (Pallas kernel in
    interpret mode), recording the kernel's inputs and raw outputs.
    Cached: each interpret-mode kernel compiles once per file."""
    s, jt, _ = _system(n, L, charged=charged)
    jg, _ = _grids(s)
    Lv = jnp.asarray(np.full(3, L, np.float32))
    jperm, _ = j_build_cell_slots(jnp.asarray(s["r"]), jnp.asarray(s["fmask"]),
                                  Lv, jg)
    jh = j_half_grid(jg)
    kernel = make_pallas_cellpair_half(jh, jt, coulomb=charged,
                                       interpret=True)
    seen = {}

    def eval_fn(*args):
        seen["args"] = tuple(np.asarray(a) for a in args)
        out = kernel(*args)
        seen["out"] = tuple(np.asarray(o) for o in out)
        return out

    res = pallas_cellpair_eval_half(
        jnp.asarray(s["r"]), jnp.asarray(s["q"]),
        jnp.asarray(s["t"], jnp.int32), jperm, Lv, jh, jt,
        jnp.asarray(j_pack_stencil(jh)), eval_fn)
    return tuple(np.asarray(x) for x in res), seen["args"], seen["out"]


@pytest.mark.parametrize("charged", [False, True])
@pytest.mark.parametrize("n,L", GEOMETRIES)
def test_eval_half_plain_matches_pallas_interpret(n, L, charged):
    """cellpair_eval_half on CPU tensors (the plain twin) == the JAX
    package's pallas_cellpair_eval_half with the Pallas kernel in
    interpret mode, two LJ types (T=2), with and without RF Coulomb."""
    s, _, tt = _system(n, L, charged=charged)
    _, tg = _grids(s)
    th = tcp.half_grid(tg)
    Lv = torch.full((3,), L, dtype=torch.float32)
    tperm, _ = tcp.build_cell_slots(torch.tensor(s["r"]),
                                    torch.tensor(s["fmask"]), Lv, tg)
    before = tch.cellpair_half.launches
    f2, e2, v2, pe2 = tch.cellpair_eval_half(
        torch.tensor(s["r"]), torch.tensor(s["q"]), torch.tensor(s["t"]),
        tperm, Lv, th, tt, tch.grid_tensors(th, "cpu"), coulomb=charged)
    assert tch.cellpair_half.launches == before   # CPU: plain twin, no launch
    f1, e1, v1, pe1 = _jax_half(n, L, charged)[0]
    _assert_close(f1, e1, v1, pe1, f2.numpy(), e2.item(), v2.numpy(),
                  pe2.numpy())


@pytest.mark.parametrize("n,L", GEOMETRIES)
def test_wrapper_on_jax_packed_slots(n, L):
    """Feed the JAX package's own packed records, stencil, L8 and counts
    straight into the port's wrapper and hold its raw outputs (p side,
    accumulated q side, per-cell e + virial6) against the Pallas kernel's."""
    _, tt = _system(n, L, charged=True)[1:]
    _, (slots, stencil, L8, counts), (j_p, j_q, j_cell) = _jax_half(
        n, L, True)
    ncell = slots.shape[0]
    before = tch.cellpair_half.launches
    t_p, t_q, t_cell = tch.cellpair_half(
        torch.tensor(slots), torch.tensor(stencil.reshape(ncell, -1)),
        torch.tensor(L8), torch.tensor(counts.astype(np.int32)), tt["sigma"],
        tt["eps"], tt["shift"], krf=tt["krf"], crf=tt["crf"], keR=tt["keR"],
        coulomb=True)
    assert tch.cellpair_half.launches == before
    scale = max(1.0, float(np.abs(j_p[:, :3]).max()))
    assert np.abs(t_p.numpy()[:, :3] - j_p[:, :3]).max() / scale < 2e-5
    assert np.abs(t_q.numpy()[:, :3] - j_q[:, :3]).max() / scale < 2e-5
    np.testing.assert_allclose(t_p.numpy()[:, 3], j_p[:, 3], rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(t_q.numpy()[:, 3], j_q[:, 3], rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(t_q.numpy()[:, 4:], 0.0)
    np.testing.assert_allclose(t_cell.numpy()[:, 0], j_cell[:, 0, 0],
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(t_cell.numpy()[:, 1:7], j_cell[:, 1:7, 0],
                               rtol=2e-3, atol=0.5)


def test_wrapper_checks_its_arguments():
    """Wrong dtype, shape or layout is refused before any kernel sees it;
    empty exclusion channels (rows 6-7 zero) mask nothing."""
    ncell, cap = 8, 128
    slots = torch.zeros((ncell, 8, cap))
    stencil = torch.zeros((ncell, 56), dtype=torch.int32)
    L8 = torch.zeros((1, 8))
    counts = torch.zeros((ncell,), dtype=torch.int32)
    tab = torch.ones((1, 1))
    kw = dict(krf=0.0, crf=0.0, keR=0.0, coulomb=False)
    with pytest.raises(ValueError):
        tch.cellpair_half(slots.double(), stencil, L8, counts, tab, tab, tab,
                          **kw)
    with pytest.raises(ValueError):
        tch.cellpair_half(slots, stencil.long(), L8, counts, tab, tab, tab,
                          **kw)
    with pytest.raises(ValueError):
        tch.cellpair_half(slots.transpose(1, 2).contiguous().transpose(1, 2),
                          stencil, L8, counts, tab, tab, tab, **kw)
    out_p, out_q, out_cell = tch.cellpair_half(slots, stencil, L8, counts,
                                               tab, tab, tab, **kw)
    assert out_p.shape == (ncell * cap, 4)
    assert out_q.shape == (ncell, 8, cap) and out_cell.shape == (ncell, 8)
    ex = tch.cellpair_half(slots, stencil, L8, counts, tab, tab, tab,
                           excl=True, **kw)
    for a, b in zip(ex, (out_p, out_q, out_cell)):
        assert torch.equal(a, b)
