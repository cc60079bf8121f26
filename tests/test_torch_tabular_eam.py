"""Slice 11, tabulated EAM in the port against the JAX package: the
TABULAR compile and its tables, the tabularFit=rational refit (bit for
bit), the shifted RATIONAL and TABULAR per-pair forms and embedding, and
the refit's plain versions of the EAM kernels (#4, #5, #7) against the
Pallas kernels in interpret mode (the engines and the drivers are in
tests/test_torch_cellblock_eam.py).

The TABULAR deck is chip_smoke.tabular_eam_deck: the eam_crystal deck's
three FIT functions sampled into files.  Tolerances:
  * host numpy code and tables: bit for bit;
  * per-pair forms and the embedding in f64: rel 1e-12;
  * the f64 engines: forces 1e-9 of the force scale, energy rel 1e-12,
    virial and per-particle energy rel 1e-9;
  * the refit's f32 plain versions against the Pallas kernels: energy
    rel 2e-5, virial rel 5e-3 abs 1.0, per-particle energy 2e-5 of its
    largest (the EAM tolerances of tests/test_torch_eam.py), forces
    REFIT_F_REL = 5e-4 of the scale.  The forces are derivatives of
    degree-19 rationals in f32: each f32 evaluation sits ~1e-4 of the
    scale from its f64 value, and the Pallas side, jitted on the CPU,
    contracts the Horner sums into fused multiply-adds while the plain
    versions (and the kernels, built with --fmad=false) do not, so the
    two f32 sums differ by ~2e-4 of the scale; op by op the JAX and port
    forms are equal bit for bit.  So each side is also held to the
    refit's f64 forces: the port's no further than 1.25 times the
    Pallas kernel's distance;
  * the drivers on the CPU: as the sums they run (f32 kernels' plain
    versions against JAX's f64 engine at the EAM tolerances; the mesh
    against Simulation at rel 2e-5)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.objects import DeckError as JDeckError
from ddcmd_tpu.ops import cellpair as jcp
from ddcmd_tpu.ops import cellpair_eam as jce
from ddcmd_tpu.parallel import pallas_shard as jps
from ddcmd_tpu.potentials import eam as jeam
from ddcmd_tpu_torch.core.system import build_system as t_build_system
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.objects import DeckError as TDeckError
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_half as tch
from ddcmd_tpu_torch.ops import eam_half as teh
from ddcmd_tpu_torch.potentials import eam as team
from test_torch_eam import (E_REL, V_ABS, V_REL, _fcc, _jax_eval,
                            _port_eval)

torch.set_num_threads(2)

F64_REL = 1e-9
REFIT_F_REL = 5e-4
DEGREE = 19                        # the refit's Horner degree on this deck


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """{"tab": the TABULAR deck, "fit": its refit, "rat": the RATIONAL
    deck whose functions they sample} at nc = 4, LANGEVIN."""
    out = {}
    for name in ("tab", "fit", "rat"):
        d = str(tmp_path_factory.mktemp(name))
        if name == "rat":
            chip_smoke.eam_deck(d, 4, 5)
        else:
            chip_smoke.tabular_eam_deck(d, 4, 5, fit=name == "fit")
        out[name] = d
    return out


@pytest.fixture(scope="module")
def parms(decks):
    """compile_eam of the decks in both packages: {(name, pkg): parms}."""
    out = {}
    for name, d in decks.items():
        out[name, "jax"] = j_build_system(j_load(d)[0], d).potentials[0][2]
        out[name, "torch"] = t_build_system(t_load(d)[0], d).potentials[0][2]
    return out


# ---------------------------------------------------------------------------
# (a) the host side: the TABULAR tables and the refit
# ---------------------------------------------------------------------------

def test_tabular_tables_equal_jax(parms):
    """compile_eam of the TABULAR deck and eam_device_tables: the stacked
    tables, their x0 / inv_dx / m and rcut2 equal the JAX package's;
    eam_device_tables takes either package's parms."""
    jp, tp = parms["tab", "jax"], parms["tab", "torch"]
    assert (tp.form, tp.n_species, tp.rcut) == ("TABULAR", 1, jp.rcut)
    jt = jeam.eam_device_tables(jp, dtype=jnp.float64)
    for p in (tp, jp):
        tt = team.eam_device_tables(p, dtype=torch.float64)
        for side in ("pair", "embed"):
            assert tt[side]["m"] == jt[side]["m"]
            for k in ("vals", "ders", "x0", "inv_dx"):
                np.testing.assert_array_equal(tt[side][k].numpy(),
                                              np.asarray(jt[side][k]))
        assert tt["rcut2"] == float(jt["rcut2"])


def test_fit_tabular_rational_equals_jax(parms):
    """The refit through the deck and through fit_tabular_rational on the
    JAX package's TABULAR parms: the same coefficients, shifts, scales,
    cutoffs and residual, bit for bit (np.linalg.lstsq on the same
    inputs), and the degrees of this deck (phi 11, rho and F 19)."""
    jp, tp = parms["fit", "jax"], parms["fit", "torch"]
    assert (tp.form, jp.form) == ("RATIONAL", "RATIONAL")
    assert tp.pair_tables["phiP"].shape == (1, 11)
    assert tp.pair_tables["rhoP"].shape == (1, DEGREE)
    assert tp.embed_tables["P"].shape == (1, DEGREE)
    jtab = parms["tab", "jax"]
    (jf, jerr), (tf, terr) = (jeam.fit_tabular_rational(jtab),
                              team.fit_tabular_rational(jtab))
    assert terr == jerr and terr < 1e-3
    for got, ref in ((tp, jp), (tf, jf)):
        for tt, jt in ((got.pair_tables, ref.pair_tables),
                       (got.embed_tables, ref.embed_tables)):
            assert sorted(tt) == sorted(jt)
            for k in jt:
                np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    assert np.isinf(tp.embed_tables["cut"]).all()


def test_tabular_fit_tol_raises_alike(decks, tmp_path):
    """A tabularFitTol below the residual raises DeckError in both."""
    with open(os.path.join(decks["fit"], "object.data")) as f:
        text = f.read().replace("tabularFit=rational;",
                                "tabularFit=rational; tabularFitTol=1e-6;")
    d = str(tmp_path)
    for name in ("pair.dat", "embed.dat", "atoms#000000"):
        os.symlink(os.path.join(decks["fit"], name), os.path.join(d, name))
    with open(os.path.join(d, "object.data"), "w") as f:
        f.write(text)
    for load, build, err in ((j_load, j_build_system, JDeckError),
                             (t_load, t_build_system, TDeckError)):
        with pytest.raises(err, match="exceeds tabularFitTol=1.00e-06"):
            build(load(d)[0], d)


@pytest.mark.parametrize("case", ["tab", "fit"])
def test_pair_eval_and_embedding_equal_jax(case, parms):
    """_pair_eval (both derivative orders) and _embedding of the TABULAR
    form (lookups, clamped past both ends) and of the refit (the shifted
    RATIONAL) in f64 on seeded r^2 and rho, rel 1e-12."""
    p = parms[case, "jax"]
    jt = jeam.eam_device_tables(p, dtype=jnp.float64)
    tt = team.eam_device_tables(p, dtype=torch.float64)
    rng = np.random.default_rng(5)
    r2 = rng.uniform(0.13 ** 2, 0.56 ** 2, 4096)
    ir2 = 1.0 / r2
    ir = np.sqrt(ir2)
    for deriv in (False, True):
        j_out = jeam._pair_eval(p.form, jt["pair"], 0, jnp.asarray(r2),
                                jnp.asarray(ir), jnp.asarray(ir2), deriv)
        t_out = team._pair_eval(p.form, tt["pair"], 0, torch.tensor(r2),
                                torch.tensor(ir), torch.tensor(ir2), deriv)
        for k in range(2):
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                       rtol=1e-12, atol=0)
    rho = rng.uniform(-5.0, 450.0, 4096)
    tid = np.zeros(4096, np.int64)
    j_out = jeam._embedding(p.form, jt["embed"], jnp.asarray(tid),
                            jnp.asarray(rho))
    t_out = team._embedding(p.form, tt["embed"], torch.tensor(tid),
                            torch.tensor(rho))
    for k in range(2):
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=1e-12, atol=0)


def test_refit_kernel_row(parms):
    """eam_kernel_tables of the refit: the kernel form RATIONAL_SHIFTED
    (eam::kRationalShifted), Horner degree 19, 82 floats a row that
    unpack to the device tables (phi zero-padded from 11); the TABULAR
    deck is not a kernel deck."""
    tt = team.eam_device_tables(parms["fit", "torch"])
    kt = teh.eam_kernel_tables(tt)
    assert (kt["form"], kt["kform"], kt["degree"]) == \
        ("RATIONAL", "RATIONAL_SHIFTED", DEGREE)
    assert kt["params"].shape == (1, 82) == \
        (1, teh.n_params("RATIONAL_SHIFTED", DEGREE))
    assert teh.FORMS.index("RATIONAL_SHIFTED") == 5
    back = teh._unpack("RATIONAL_SHIFTED", kt["params"], DEGREE)
    assert sorted(back) == sorted(tt["pair"])
    for k, v in tt["pair"].items():
        w = back[k].reshape(1, -1)
        v = v.reshape(1, -1)
        torch.testing.assert_close(w[:, :v.shape[1]], v, rtol=0, atol=0)
        assert not w[:, v.shape[1]:].any()
    rat = teh.eam_kernel_tables(team.eam_device_tables(parms["rat", "torch"]))
    assert rat["kform"] == "RATIONAL"
    assert not teh.eam_half_supported(
        team.eam_device_tables(parms["tab", "torch"]))


def test_refit_plan_fits_shared_memory():
    """The nc = 32 refit deck keeps the crystal's column plan: its 82
    floats a row (the RATIONAL row's 78 plus the shift) add 16 bytes to
    the column force pass over the RATIONAL deck of degree 19, 72,876
    bytes at U = 29, cap 128, which fits, so fit_col_group keeps G = 4."""
    L = [32 * 0.3615] * 3
    tg = tch.plan_lanes(L, 0.55, 0.1, 4 * 32 ** 3)
    th = tcp.half_grid(tg)
    assert (tg.ncells, tg.cap) == ((11, 12, 12), 128)
    npar = teh.n_params("RATIONAL_SHIFTED", DEGREE)
    assert tch.fit_col_group(th, tch.choose_col_group(th),
                             lambda u: teh.eam_col_smem_bytes(
                                 u, th.cap, 1, npar)) == 4
    assert len(tch.col_plan_grid(th, 4)[0]) == 29
    assert teh.eam_col_smem_bytes(29, 128, 1, npar) == 72_876


# ---------------------------------------------------------------------------
# (b) the refit's plain versions of #4, #5, #7 against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crystal500():
    """The 500-atom jittered fcc(0.3615, 5) of tests/test_torch_eam.py
    and its JAX plan and perm."""
    from ddcmd_tpu.ops import pallas_cellpair as jpc

    r, L = _fcc(0.3615, 5)
    rng = np.random.default_rng(17)
    r = (r + rng.standard_normal(r.shape) * 0.006).astype(np.float32)
    n = len(r)
    grid = jpc.plan_lanes([L] * 3, 0.55, 0.1, n)
    perm, ov = jcp.build_cell_slots(jnp.asarray(r), jnp.ones(n, jnp.float32),
                                    jnp.asarray([L] * 3, jnp.float32), grid)
    assert not bool(ov)
    return r, L, grid, np.asarray(perm)


def _jax_cellblock(r, sidx, fmask, geom, p, dtype=jnp.float64):
    """The JAX cell-block EAM engine on r in box geom ((3,) or (3,3))."""
    n = len(r)
    jg = jcp.CellBlockGrid.plan(np.asarray(geom, np.float64), 0.55, 0.1, n)
    jh = jcp.half_grid(jg)
    perm, ov = jcp.build_cell_slots(jnp.asarray(r, dtype), jnp.ones(n, dtype),
                                    jnp.asarray(geom, dtype), jg)
    assert not bool(ov)
    jt = jeam.eam_device_tables(p, dtype=dtype)
    bm = jnp.asarray(jcp.half_back_map(jh))
    out = jax.jit(lambda *a: jce.eam_cellblock_eval_half(*a, jh, jt, bm))(
        jnp.asarray(r, dtype), jnp.asarray(sidx), jnp.asarray(fmask, dtype),
        perm, jnp.asarray(geom, dtype))
    return tuple(np.asarray(x, np.float64) for x in out)


@pytest.mark.parametrize("G", [1, 2])
def test_refit_twins_match_pallas_interpret(G, crystal500, parms):
    """eam_eval_half on the refit's per-cell (#4, G = 1) and column (#5,
    G = 2 on the (2, 2, 2) grid, nz == G) plain versions == pallas_eam_eval
    in interpret mode, at the tolerances of the module docstring, and
    both held to the refit's f64 forces (the JAX cell-block engine)."""
    r, L, grid, perm = crystal500
    p = parms["fit", "jax"]
    sidx = np.zeros(len(r), np.int64)
    (tf, te, tv, tpe) = _port_eval(r, L, sidx, perm, p, G)
    (jf, je, jv, jpe_) = _jax_eval(r, L, sidx, grid, perm, p, G)
    assert te == pytest.approx(je, rel=E_REL)
    assert tv == pytest.approx(jv, rel=V_REL, abs=V_ABS)
    assert np.abs(tpe - jpe_).max() <= E_REL * np.abs(jpe_).max()
    scale = np.abs(jf).max()
    assert np.abs(tf - jf).max() <= REFIT_F_REL * scale
    f64 = _jax_cellblock(r.astype(np.float64), sidx, np.ones(len(r)),
                         [L] * 3, p)[0]
    assert np.abs(tf - f64).max() <= 1.25 * np.abs(jf - f64).max() \
        + 1e-6 * scale


def test_refit_ext_twins_match_pallas_shard_interpret(parms):
    """The extended-grid passes (#7) on the refit: shard_eam_rho /
    shard_eam_force over the plain versions against the JAX package's
    with make_shard_eam_kernels in interpret mode, on one brick of a
    (2,2,2) plan of an nc = 8 crystal (the harness of
    tests/test_torch_shard.py:test_eam_modules_match_pallas_interpret);
    forces from the same dF at REFIT_F_REL of the scale."""
    from ddcmd_tpu_torch.parallel import shard_cells as tsc
    from test_torch_shard import CU, Brick, _close
    from test_torch_shard import _fcc as shard_fcc

    p = parms["fit", "jax"]
    r, rng = shard_fcc(8, seed=11)
    b = Brick(r, [8 * CU] * 3, (2, 2, 2), (1, 1, 0), 0.55, 0.1)
    tidx = np.zeros(b.n, np.int64)
    jt = jeam.eam_device_tables(p, dtype=jnp.float32)
    jrho, jforce = jps.make_shard_eam_kernels(b.jp, jt, interpret=True)
    j_rp, jslots, jL8 = jps.shard_eam_rho(b.ju, jnp.asarray(tidx), b.jperm,
                                          b.jspan, b.jp, jt, jrho)
    tt = teh.eam_kernel_tables(team.eam_device_tables(p))
    trho, tforce = tsc.make_shard_eam_kernels(b.tp, tt, "cpu")
    assert trho.kw["form"] == "RATIONAL_SHIFTED"
    t_rp, tslots, tL8 = tsc.shard_eam_rho(b.tu, torch.tensor(tidx), b.tperm,
                                          b.tcounts, b.tspan, b.tp, tt, trho)
    j_rp = np.asarray(j_rp)
    assert float(np.abs(t_rp[:, 0].numpy() - j_rp[:, 0]).max()) <= \
        E_REL * float(np.abs(j_rp[:, 0]).max())
    assert float(t_rp[:, 1].double().sum()) == pytest.approx(
        float(j_rp[:, 1].astype(np.float64).sum()), rel=E_REL)
    dF = rng.standard_normal(b.n) * 0.05
    jf, jv = jps.shard_eam_force(jslots, jL8, jnp.asarray(dF, jnp.float32),
                                 b.jperm, b.jp, jforce)
    tf, tv = tsc.shard_eam_force(tslots, tL8, b.tcounts, torch.tensor(dF),
                                 b.tperm, b.tp, tforce)
    _close(tf.numpy(), np.asarray(jf), REFIT_F_REL, "force")
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=V_REL,
                               atol=V_ABS)
