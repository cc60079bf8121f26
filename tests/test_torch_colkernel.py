"""The column plan, the exclusion channels in the slot records and both
pair kernels' plain twins against the JAX package's Pallas kernels in
interpret mode (per-cell with exclusions, column with and without them,
nz == G grids included), and the deep-compression case of the bilayer."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.ops import pallas_cellpair as jpc
from ddcmd_tpu.ops.cellpair import build_cell_slots as j_build_cell_slots
from ddcmd_tpu.ops.cellpair import half_grid as j_half_grid
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_half as tch

from tests.test_nbr_martini import make_system

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    """The JAX package's column rule reads these knobs: hold it to its
    defaults (bcast variant, auto group size)."""
    for k in ("DDCMD_PALLAS_COLS", "DDCMD_PALLAS_VARIANT",
              "DDCMD_PALLAS_PCHUNK"):
        monkeypatch.delenv(k, raising=False)


# (box, beads): the full bilayer's start box, the 49k water box, the
# 6,173-bead water box and the small bilayer
PLANS = [((38.4, 38.4, 11.0), 100296), ((23.6, 23.6, 23.6), 49384),
         ((9.4, 9.4, 9.4), 6173), ((3.2, 3.2, 9.0), 528)]


@pytest.mark.parametrize("cap", [None, 256])
@pytest.mark.parametrize("L,n", PLANS)
def test_col_plan_equals_jax(L, n, cap):
    """choose_col_group, col_plan_grid and pack_stencil_col == the JAX
    package's (exact), on planned grids and with the cap grown to 256
    (g_max drops from 5 to 3); every G that divides nz is checked too,
    nz == G (aliased unions) included."""
    jg = jpc.plan_lanes(L, 1.1, 0.3, n, plan_margin=1.08)
    tg = tch.plan_lanes(L, 1.1, 0.3, n, plan_margin=1.08)
    assert (tg.ncells, tg.cap) == (jg.ncells, jg.cap)
    if cap is not None:
        jg, tg = jg.with_cap(cap), tg.with_cap(cap)
    jh, th = j_half_grid(jg), tcp.half_grid(tg)
    assert tch.choose_col_group(th) == jpc.choose_col_group(jh)
    nz = tg.ncells[2]
    for G in [g for g in range(2, 9) if nz % g == 0]:
        ju, jm = jpc.col_plan_grid(jh, G)
        tu, tm = tch.col_plan_grid(th, G)
        assert (tu, tm) == (ju, jm)
        np.testing.assert_array_equal(tch.pack_stencil_col(th, G),
                                      jpc.pack_stencil_col(jh, G))


def test_full_bilayer_plan_takes_the_column_kernel():
    """The full bilayer's start grid has >= 256 cells and nz = 5 = G: the
    column kernel over an aliased union (U = 25 < 5G + 9)."""
    th = tcp.half_grid(tch.plan_lanes((38.4, 38.4, 11.0), 1.1, 0.3, 100296,
                                      plan_margin=1.08))
    assert th.ncell >= 256 and th.cap == 128 and th.ncells[2] == 5
    assert tch.choose_col_group(th) == 5
    union, member = tch.col_plan_grid(th, 5)
    assert len(union) == 25 and len(member) == 5


def _synthetic(n, L):
    """Padded charged two-type inputs (tests/test_nbr_martini.make_system)."""
    r, q, tidx, sigma, eps, shift, rcut, krf, crf, keR = make_system(
        n=n, L=L, seed=11, charged=True)
    n_pad = ((n + 127) // 128) * 128
    pad = lambda a, s: np.concatenate([a, np.zeros((n_pad - n,) + s)])  # noqa: E731
    tables = dict(sigma=sigma, eps=eps, shift=shift, rcut2=rcut ** 2,
                  krf=krf, crf=crf, keR=keR)
    return (pad(r, (3,)).astype(np.float32), pad(q, ()).astype(np.float32),
            pad(tidx, ()).astype(np.int64),
            (np.arange(n_pad) < n).astype(np.float32), np.full(3, L), tables,
            rcut)


def _jax_pack(r, q, t, fmask, L, tables, rcut, excl_vals=None,
              margin=1.0):
    """The JAX package's packed kernel inputs (plan, binning, slots)."""
    jg = jpc.plan_lanes(L, rcut, 0.3, int(fmask.sum()), plan_margin=margin)
    perm, ov = j_build_cell_slots(jnp.asarray(r), jnp.asarray(fmask),
                                  jnp.asarray(L, jnp.float32), jg)
    assert not bool(ov)
    jh = j_half_grid(jg)
    slots, _ = jpc.pack_slots(jnp.asarray(r), jnp.asarray(q),
                              jnp.asarray(t, jnp.int32), perm,
                              jnp.asarray(L, jnp.float32), jh,
                              excl_vals=None if excl_vals is None
                              else jnp.asarray(excl_vals))
    Ln = np.asarray(L, np.float32) / np.asarray(jh.ncells, np.float32)
    L8 = np.zeros((1, 8), np.float32)
    L8[0, :3] = Ln
    L8[0, 3] = np.float32(tables["rcut2"])
    counts = (np.asarray(perm).reshape(jh.ncell, jh.cap)
              != r.shape[0]).sum(1).astype(np.int32)
    jt = {k: jnp.asarray(v, jnp.float32) for k, v in tables.items()}
    return jh, np.asarray(slots), L8, counts, jt


def _compare_raw(t_out, j_out):
    """Raw kernel outputs at the tolerances of tests/test_pallas_cellpair
    .py: force 2e-5 of scale, pe rtol 1e-3 / atol 2e-3, e rtol 1e-4 /
    atol 1e-2, virial rtol 2e-3 / atol 0.5."""
    (t_p, t_q, t_cell), (j_p, j_q, j_cell) = t_out, j_out
    t_p, t_q, t_cell = (x.numpy() for x in (t_p, t_q, t_cell))
    scale = max(1.0, float(np.abs(j_p[:, :3]).max()))
    assert np.abs(t_p[:, :3] - j_p[:, :3]).max() / scale < 2e-5
    assert np.abs(t_q[:, :3] - j_q[:, :3]).max() / scale < 2e-5
    np.testing.assert_allclose(t_p[:, 3], j_p[:, 3], rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(t_q[:, 3], j_q[:, 3], rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(t_q[:, 4:], 0.0)
    np.testing.assert_allclose(t_cell[:, 0], j_cell[:, 0, 0], rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(t_cell[:, 1:7], j_cell[:, 1:7, 0], rtol=2e-3,
                               atol=0.5)


def _tt(tables):
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    return (dict(krf=f32(tables["krf"]), crf=f32(tables["crf"]),
                 keR=f32(tables["keR"])),
            [torch.tensor(np.asarray(tables[k]), dtype=torch.float32)
             for k in ("sigma", "eps", "shift")])


# (n, L): grids (1, 2, 2) and (2, 2, 3) -- nz == G for G = 2 and 3
@pytest.mark.parametrize("n,L", [(220, 4.2), (800, 6.6)])
def test_col_twin_matches_pallas_interpret(n, L):
    """cellpair_half_col on CPU tensors (the plain twin) == the JAX
    package's make_pallas_cellpair_half_col (interpret mode) on the same
    packed slots, charged, two LJ types, G = nz (aliased union)."""
    r, q, t, fmask, Lv, tables, rcut = _synthetic(n, L)
    jh, slots, L8, counts, jt = _jax_pack(r, q, t, fmask, Lv, tables, rcut)
    G = jh.ncells[2]
    stencil = jpc.pack_stencil_col(jh, G)
    j_out = jpc.make_pallas_cellpair_half_col(jh, jt, G, coulomb=True,
                                              interpret=True)(
        jnp.asarray(slots), jnp.asarray(stencil), jnp.asarray(L8),
        jnp.asarray(counts))
    kw, tabs = _tt(tables)
    _, member = tch.col_plan_grid(tcp.half_grid(tch.plan_lanes(
        Lv, rcut, 0.3, n)), G)
    before = tch.cellpair_half_col.launches
    t_out = tch.cellpair_half_col(
        torch.tensor(slots), torch.tensor(stencil),
        torch.tensor(np.asarray(member, np.int32)), torch.tensor(L8),
        torch.tensor(counts), *tabs, coulomb=True, **kw)
    assert tch.cellpair_half_col.launches == before   # CPU: the twin
    assert t_out[2].shape == (jh.ncell // G, 8)
    _compare_raw(t_out, tuple(np.asarray(o) for o in j_out))


@pytest.fixture(scope="module")
def bilayer(tmp_path_factory):
    """The small bilayer's positions, charges, LJ types, exclusion
    channels and tables (the JAX package's system)."""
    from ddcmd_tpu.core.system import build_system
    from ddcmd_tpu.models import load, martini_bilayer
    from ddcmd_tpu.potentials.martini import martini_device_tables
    from ddcmd_tpu.run.forces import _excl_channels

    d = str(tmp_path_factory.mktemp("bilayer"))
    martini_bilayer(d, nx=4, ny=4, water_nm=1.2)
    sd = build_system(load(d)[0], d)
    mp = sd.potentials[0][2]
    tab = martini_device_tables(mp)
    tables = {k: np.asarray(v) for k, v in tab.items()}
    st = sd.state
    L = np.asarray(sd.box.lengths, np.float64)
    r = np.asarray(sd.box.back_in_box(st.r), np.float32)
    t = np.asarray(mp.species_lj_type)[np.asarray(st.species)]
    return (r, np.asarray(st.q, np.float32), t.astype(np.int64),
            np.asarray(st.fmask, np.float32), L, tables,
            _excl_channels(sd.bonded.exclusions, st.n_pad), d)


def test_excl_slots_and_twin_match_pallas_interpret(bilayer):
    """pack_slots with exclusion channels == the JAX package's (exact),
    and the per-cell twin with excl=True == make_pallas_cellpair_half
    (excl=True, interpret mode) on those slots; the column twin over the
    same slots with G = nz = 2 == make_pallas_cellpair_half_col."""
    r, q, t, fmask, L, tables, ev, _ = bilayer
    jh, slots, L8, counts, jt = _jax_pack(r, q, t, fmask, L, tables, 1.1,
                                          excl_vals=ev, margin=1.08)
    assert jh.ncells == (2, 2, 2)
    # the port's packing of the same particles
    tg = tch.plan_lanes(L, 1.1, 0.3, int(fmask.sum()), plan_margin=1.08)
    tperm, _ = tcp.build_cell_slots(torch.tensor(r), torch.tensor(fmask),
                                    torch.tensor(L, dtype=torch.float32), tg)
    th = tcp.half_grid(tg)
    gt = tch.grid_tensors(th, "cpu")
    tslots, _ = tch.pack_slots(torch.tensor(r), torch.tensor(q),
                               torch.tensor(t), tperm,
                               torch.tensor(L, dtype=torch.float32), th,
                               gt["frac_centers"],
                               excl_vals=torch.tensor(ev))
    np.testing.assert_array_equal(tslots.numpy(), slots)
    assert (slots[:, 6] > 0).any() and (slots[:, 7] > 0).any()

    kw, tabs = _tt(tables)
    stencil = jpc.pack_stencil(jh)
    j_out = jpc.make_pallas_cellpair_half(jh, jt, coulomb=True,
                                          interpret=True, excl=True)(
        jnp.asarray(slots), jnp.asarray(stencil.reshape(-1)),
        jnp.asarray(L8), jnp.asarray(counts))
    t_out = tch.cellpair_half(torch.tensor(slots),
                              torch.tensor(stencil.reshape(jh.ncell, -1)),
                              torch.tensor(L8), torch.tensor(counts), *tabs,
                              coulomb=True, excl=True, **kw)
    _compare_raw(t_out, tuple(np.asarray(o) for o in j_out))
    # without the mask the bonded pairs' LJ walls change the energy
    t_all = tch.cellpair_half(torch.tensor(slots),
                              torch.tensor(stencil.reshape(jh.ncell, -1)),
                              torch.tensor(L8), torch.tensor(counts), *tabs,
                              coulomb=True, excl=False, **kw)
    assert abs(float(t_all[2][:, 0].sum() - t_out[2][:, 0].sum())) > 1.0

    G = 2
    cstencil = jpc.pack_stencil_col(jh, G)
    j_col = jpc.make_pallas_cellpair_half_col(jh, jt, G, coulomb=True,
                                              interpret=True, excl=True)(
        jnp.asarray(slots), jnp.asarray(cstencil), jnp.asarray(L8),
        jnp.asarray(counts))
    _, member = tch.col_plan_grid(th, G)
    t_col = tch.cellpair_half_col(
        torch.tensor(slots), torch.tensor(cstencil),
        torch.tensor(np.asarray(member, np.int32)), torch.tensor(L8),
        torch.tensor(counts), *tabs, coulomb=True, excl=True, **kw)
    _compare_raw(t_col, tuple(np.asarray(o) for o in j_col))


def test_deep_compression_has_no_nonbond_force(bilayer):
    """A bonded pair compressed to 0.12 nm (the rare ~11 kT fluctuation
    that detonated the 94k bilayer on the TPU) gets no nonbond force at
    all: masked in the kernel, not computed and subtracted.  The port's
    forces there (bond + angle, O(1e3), not the O(1e9) LJ wall) match the
    JAX package's in-list-masking (N,K)-list engine to 2e-4 of scale, as
    tests/test_pallas_cellpair.py holds its pallas engine."""
    from ddcmd_tpu.models import load as j_load
    from ddcmd_tpu.run.simulate import Simulation as JSimulation
    from ddcmd_tpu_torch.models import load as t_load
    from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

    d = bilayer[-1]
    js = JSimulation(*j_load(d), run_dir=d, engine="nlist")
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu")
    n = ts.sysdef.state.n_local
    r = ts.ss.state.r.numpy().copy()
    # GL1-GL2 of the first lipid are rows 2, 3 (builder bead order)
    dv = r[3] - r[2]
    r[3] = r[2] + dv / np.linalg.norm(dv) * 0.12
    js.ss = js.ss.replace(state=js.ss.state.replace(r=jnp.asarray(r)))
    ts.ss = ts.ss.replace(state=ts.ss.state.replace(r=torch.tensor(r)))
    js.first_energy()
    ts.first_energy()
    ft = ts.ss.state.f.numpy()[:n]
    fj = np.asarray(js.ss.state.f)[:n]
    assert np.isfinite(ft).all()
    assert np.abs(ft[2:4]).max() < 1e5
    scale = max(1.0, np.abs(fj).max())
    assert np.abs(ft - fj).max() / scale < 2e-4


# (plan box, particles, rcut, skin): the 49k water box (nz = 9) and the
# 131,072-atom copper crystal's grid (11, 12, 12)
FIT_PLANS = {"water49k": ((23.6, 23.6, 23.6), 49384, 1.1, 0.3),
             "grid_11_12_12": ([32 * 0.3615] * 3, 4 * 32 ** 3, 0.55, 0.1)}


@pytest.mark.parametrize("plan,excl,G", [("water49k", False, 3),
                                         ("water49k", True, 3),
                                         ("grid_11_12_12", False, 3),
                                         ("grid_11_12_12", True, 3)])
def test_fit_col_group_lowers_g_to_fit(plan, excl, G):
    """Both plans with the cap grown to 384, as the overflow ladder may
    grow it: the JAX rule gives G = 3, U = 24.  The pair kernel's column
    launch is its per-cell CTA over the column tables, so its shared
    memory does not grow with U (T = 5 tables, with or without the two
    exclusion rows, well within the 232,448 bytes a block may use) and
    the fit rule keeps G = 3.  A count that grows with U past the limit
    at U = 24 is lowered to the largest divisor of nz whose union fits:
    G = 2 (U = 19) on the (11, 12, 12) grid, and the per-cell kernel on
    the water box, whose nz = 9 has no divisor 2."""
    L, n, rcut, skin = FIT_PLANS[plan]
    th = tcp.half_grid(tch.plan_lanes(L, rcut, skin, n,
                                      plan_margin=1.08).with_cap(384))
    assert tch.choose_col_group(th) == 3
    assert len(tch.col_plan_grid(th, 3)[0]) == 24
    assert tch.cell_smem_bytes(384, 5, excl) <= tch.SMEM_LIMIT
    if th.ncells[2] % 2 == 0:
        assert len(tch.col_plan_grid(th, 2)[0]) == 19
    assert tch.fit_col_group(th, 3, lambda u: tch.cell_smem_bytes(
        384, 5, excl)) == G
    lowered = 2 if th.ncells[2] % 2 == 0 else 1
    assert tch.fit_col_group(th, 3, lambda u: tch.SMEM_LIMIT + (u > 19)) \
        == lowered


@pytest.mark.parametrize("cap,G", [(128, 4), (256, 3), (384, 3), (512, 2),
                                   (1024, 1)])
def test_fit_col_group_eam_bytes(cap, G):
    """The same rule on the EAM force pass's byte count (the larger pass)
    over the 131,072-atom copper crystal's grid (11, 12, 12).  The column
    kernels keep the union's q-side sums in shared memory, not its
    records: at cap 128 G = 4 (U = 29) fits, at cap 256 and 384 the JAX
    rule's G = 3 (U = 24), at cap 512 only G = 2 (U = 19), and at cap 1024
    neither, so the per-cell EAM kernels run."""
    from ddcmd_tpu_torch.ops import eam_half as teh

    npar = teh.n_params("RATIONAL", 4)
    th = tcp.half_grid(tch.plan_lanes([32 * 0.3615] * 3, 0.55, 0.1,
                                      4 * 32 ** 3).with_cap(cap))
    assert th.ncells == (11, 12, 12)
    fits = {g: teh.eam_col_smem_bytes(len(tch.col_plan_grid(th, g)[0]), cap,
                                      1, npar) <= tch.SMEM_LIMIT
            for g in (2, 3, 4)}
    assert tch.fit_col_group(th, tch.choose_col_group(th), lambda u:
                             teh.eam_col_smem_bytes(u, cap, 1, npar)) == G
    assert fits[G] if G > 1 else not (fits[2] or fits[3])
