"""The pair kernels' plain versions (what the card holds the kernels
against) against the JAX package's Pallas kernels in interpret mode on
the JAX package's own packed slots, in the cases the pruned two-phase
sweep must survive, as chip_smoke.py runs them on the card: a ragged
occupancy (cells of 0, 1, 31, 32, 33 and cap live slots, some slots
masked inside the counts) and a stale binning (slots packed from a
binning made before the particles moved by up to half the skin, most of
it one common step, so particles near a face lie outside their cells).
Charged, two LJ types, with and without exclusion channels; the per-cell
kernel (TPU #1) and the column kernel (TPU #2) at G = nz = 3, an aliased
union; the full-stencil kernel (TPU #3) on the same records, its 27
directions reaching the 2-cell axes' one neighbour through two images."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.ops import pallas_cellpair as jpc
from ddcmd_tpu.ops.cellpair import CellBlockGrid as JGrid
from ddcmd_tpu.ops.cellpair import _build_stencil as j_build_stencil
from ddcmd_tpu.ops.cellpair import build_cell_slots as j_build_cell_slots
from ddcmd_tpu.ops.cellpair import half_grid as j_half_grid
from ddcmd_tpu.run.forces import _excl_channels as j_excl_channels
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_full as tcf
from ddcmd_tpu_torch.ops import cellpair_half as tch

torch.set_num_threads(2)

NCELLS, CAP = (2, 2, 3), 128      # cells of 1.3 nm, as chip_smoke's cap 128


@functools.lru_cache(maxsize=None)
def _case(stale: bool, excl: bool):
    """JAX-packed kernel inputs (half grid, slots, per-cell stencil,
    column stencil, L8, counts) of chip_smoke.ragged_system on NCELLS
    cells, charged, its masked tenth zero in the validity row; stale:
    binned before the particles moved by chip_smoke.drift (up to half the
    skin) and packed at the moved positions."""
    import chip_smoke as cs

    r, L, t, valid, _ = cs.ragged_system(ncells=NCELLS, cap=CAP)
    rng = np.random.default_rng(5)
    n = len(r)
    n_pad = ((n + 127) // 128) * 128
    pad = lambda a: np.concatenate(                            # noqa: E731
        [a, np.zeros((n_pad - n,) + a.shape[1:], a.dtype)])
    q = rng.choice([-0.3, 0.0, 0.3], n).astype(np.float32)
    grid = JGrid(NCELLS, CAP, cs.RAGGED_RCUT + cs.RAGGED_SKIN,
                 *j_build_stencil(NCELLS))
    fmask = (np.arange(n_pad) < n).astype(np.float32)
    Lj = jnp.asarray(L, jnp.float32)
    perm, ov = j_build_cell_slots(jnp.asarray(pad(r)), jnp.asarray(fmask), Lj,
                                  grid)
    assert not bool(ov)
    if stale:
        r = (r + cs.drift(rng, n)).astype(np.float32)
    ev = None
    if excl:
        ev = jnp.asarray(j_excl_channels(cs.chain_exclusions(r, rng), n_pad))
    jh = j_half_grid(grid)
    slots, _ = jpc.pack_slots(jnp.asarray(pad(r)), jnp.asarray(pad(q)),
                              jnp.asarray(pad(t), jnp.int32), perm, Lj, jh,
                              excl_vals=ev)
    slots = np.array(slots)
    perm = np.asarray(perm)
    slots[:, 5] = np.append(pad(valid), 0.0)[perm].reshape(jh.ncell, CAP)
    counts = (perm.reshape(jh.ncell, CAP) != n_pad).sum(1).astype(np.int32)
    live = np.arange(CAP)[None, :] < counts[:, None]
    assert sorted(set(counts.tolist())) == [*cs.RAGGED_COUNTS, CAP]
    assert (live & (slots[:, 5] == 0)).any()
    if excl:
        assert (slots[:, 6] > 0).any()
    if stale:   # some particles now lie outside the cell they were binned in
        edge = float(L[0]) / NCELLS[0]
        assert ((np.abs(slots[:, 0:3]) > edge / 2).any(1) & live).any()
    L8 = np.zeros((1, 8), np.float32)
    L8[0, :3] = np.asarray(L, np.float32) / np.asarray(NCELLS, np.float32)
    L8[0, 3] = _tables()["rcut2"]
    return (jh, slots, jpc.pack_stencil(jh), jpc.pack_stencil_col(
        jh, NCELLS[2]), L8, counts)


def _tables():
    """chip_smoke.ragged_pair_tables as f32 numpy values."""
    import chip_smoke as cs

    return {k: np.float32(v) for k, v in cs.ragged_pair_tables()[0].items()}


def _run_jax(jh, excl, G, slots, stencil, L8, counts):
    jt = {k: jnp.asarray(v) for k, v in _tables().items()}
    if G == 1:
        fn = jpc.make_pallas_cellpair_half(jh, jt, coulomb=True,
                                           interpret=True, excl=excl)
        stencil = stencil.reshape(-1)
    else:
        fn = jpc.make_pallas_cellpair_half_col(jh, jt, G, coulomb=True,
                                               interpret=True, excl=excl)
    return tuple(np.asarray(o) for o in fn(
        jnp.asarray(slots), jnp.asarray(stencil), jnp.asarray(L8),
        jnp.asarray(counts)))


def _assert_raw_close(t_out, j_out):
    """Raw outputs at the tolerances of tests/test_pallas_cellpair.py:
    force 2e-5 of scale, pe rtol 1e-3 / atol 2e-3, e rtol 1e-4 / atol
    1e-2, virial rtol 2e-3 / atol 0.5; q-side rows 4-7 exactly 0."""
    (t_p, t_q, t_cell), (j_p, j_q, j_cell) = (
        tuple(x.numpy() for x in t_out), j_out)
    scale = max(1.0, float(np.abs(j_p[:, :3]).max()),
                float(np.abs(j_q[:, :3]).max()))
    assert np.abs(t_p[:, :3] - j_p[:, :3]).max() / scale < 2e-5
    assert np.abs(t_q[:, :3] - j_q[:, :3]).max() / scale < 2e-5
    np.testing.assert_allclose(t_p[:, 3], j_p[:, 3], rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(t_q[:, 3], j_q[:, 3], rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(t_q[:, 4:], 0.0)
    np.testing.assert_allclose(t_cell[:, 0], j_cell[:, 0, 0], rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(t_cell[:, 1:7], j_cell[:, 1:7, 0], rtol=2e-3,
                               atol=0.5)


def _torch_tables():
    tab = _tables()
    return ([torch.tensor(tab[k]) for k in ("sigma", "eps", "shift")],
            dict(krf=float(tab["krf"]), crf=float(tab["crf"]),
                 keR=float(tab["keR"]), coulomb=True))


@pytest.mark.parametrize("excl", [False, True])
@pytest.mark.parametrize("stale", [False, True], ids=["ragged", "stale"])
def test_cell_plain_matches_pallas_interpret(stale, excl):
    """cellpair_half on CPU tensors (its plain version) == the JAX
    package's make_pallas_cellpair_half in interpret mode."""
    jh, slots, stencil, _, L8, counts = _case(stale, excl)
    tabs, kw = _torch_tables()
    before = tch.cellpair_half.launches
    t_out = tch.cellpair_half(
        torch.tensor(slots), torch.tensor(stencil.reshape(jh.ncell, -1)),
        torch.tensor(L8), torch.tensor(counts), *tabs, excl=excl, **kw)
    assert tch.cellpair_half.launches == before    # CPU: the plain version
    _assert_raw_close(t_out, _run_jax(jh, excl, 1, slots, stencil, L8,
                                      counts))


@pytest.mark.parametrize("excl", [False, True])
@pytest.mark.parametrize("stale", [False, True], ids=["ragged", "stale"])
def test_col_plain_matches_pallas_interpret(stale, excl):
    """cellpair_half_col on CPU tensors (its plain version) == the JAX
    package's make_pallas_cellpair_half_col in interpret mode, G = nz = 3
    (an aliased union: nx = ny = 2 too)."""
    jh, slots, _, cstencil, L8, counts = _case(stale, excl)
    G = NCELLS[2]
    import chip_smoke as cs

    _, member = tch.col_plan_grid(tcp.half_grid(cs.made_grid(
        NCELLS, CAP, cs.RAGGED_RCUT + cs.RAGGED_SKIN)), G)
    tabs, kw = _torch_tables()
    before = tch.cellpair_half_col.launches
    t_out = tch.cellpair_half_col(
        torch.tensor(slots), torch.tensor(cstencil),
        torch.tensor(np.asarray(member, np.int32)), torch.tensor(L8),
        torch.tensor(counts), *tabs, excl=excl, **kw)
    assert tch.cellpair_half_col.launches == before
    assert t_out[2].shape == (jh.ncell // G, 8)
    _assert_raw_close(t_out, _run_jax(jh, excl, G, slots, cstencil, L8,
                                      counts))


@pytest.mark.parametrize("stale", [False, True], ids=["ragged", "stale"])
def test_full_plain_matches_pallas_interpret(stale):
    """cellpair_full on CPU tensors (its plain version) == the JAX
    package's make_pallas_cellpair (TPU #3) in interpret mode on the same
    records, over the full 27-direction stencil, at the tolerances of
    tests/test_torch_fullpair.py: force 2e-5 of scale, pe rtol 1e-3 /
    atol 1e-3, e rtol 1e-4 / atol 1e-2, virial rtol 2e-3 / atol 0.5, per
    cell.  The exclusion rows are zero here; the full kernel reads none."""
    import chip_smoke as cs

    _, slots, _, _, L8, counts = _case(stale, False)
    rlist = cs.RAGGED_RCUT + cs.RAGGED_SKIN
    jg = JGrid(NCELLS, CAP, rlist, *j_build_stencil(NCELLS))
    stencil = jpc.pack_stencil(jg)
    grid = cs.made_grid(NCELLS, CAP, rlist)
    np.testing.assert_array_equal(tch.pack_stencil(grid), stencil)
    jt = {k: jnp.asarray(v) for k, v in _tables().items()}
    j_p, j_cell = (np.asarray(o) for o in jpc.make_pallas_cellpair(
        jg, jt, coulomb=True, interpret=True)(
            jnp.asarray(slots), jnp.asarray(stencil), jnp.asarray(L8)))
    tabs, kw = _torch_tables()
    before = tcf.cellpair_full.launches
    t_p, t_cell = (x.numpy() for x in tcf.cellpair_full(
        torch.tensor(slots), torch.tensor(stencil), torch.tensor(L8),
        torch.tensor(counts), *tabs, s_self=tcf.self_index(grid), **kw))
    assert tcf.cellpair_full.launches == before    # CPU: the plain version
    assert t_p.shape == (len(slots) * CAP, 4) and t_cell.shape == (len(slots), 8)
    scale = max(1.0, float(np.abs(j_p[:, :3]).max()))
    assert np.abs(t_p[:, :3] - j_p[:, :3]).max() / scale < 2e-5
    np.testing.assert_allclose(t_p[:, 3], j_p[:, 3], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(t_cell[:, 0], j_cell[:, 0, 0], rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(t_cell[:, 1:7], j_cell[:, 1:7, 0], rtol=2e-3,
                               atol=0.5)
    np.testing.assert_array_equal(t_cell[:, 7], 0.0)
