"""Slice 3, EAM: the port's deck compilation, per-pair forms and
embedding, the EAM kernels' plain twins (per-cell and column) and the EAM
crystal end to end, against the JAX package (its Pallas EAM kernels in
interpret mode, its f64 cell-block engine).

Tolerances are those of tests/test_pallas_cellpair.py:305-309 (the JAX
package's Pallas EAM against its XLA engine): energy rel 2e-5, max |df|
/ max(1, |f|max) < 5e-5, virial rel 5e-3 abs 1.0.  The forms and the
embedding are held at rel 1e-6 in f32 (both sides evaluate the same
expressions; only the libraries' exp/log/pow differ by an ulp)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import eam_crystal as j_eam_crystal
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.objects import ObjectDB as JObjectDB
from ddcmd_tpu.ops import pallas_cellpair as jpc
from ddcmd_tpu.ops import pallas_eam as jpe
from ddcmd_tpu.ops.cellpair import half_grid as j_half_grid
from ddcmd_tpu.potentials import eam as jeam
from ddcmd_tpu_torch.models import eam_crystal as t_eam_crystal
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.objects import ObjectDB as TObjectDB
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_half as tch
from ddcmd_tpu_torch.ops import eam_half as teh
from ddcmd_tpu_torch.potentials import eam as team

torch.set_num_threads(2)

E_REL, F_REL, V_REL, V_ABS = 2e-5, 5e-5, 5e-3, 1.0
FORM_RTOL = 1e-6

# two-species decks of each analytic form (per-species values in the
# units compile_eam documents); RATIONAL with an elementwise density, so
# rho(Cu, Ag) != rho(Ag, Cu)
DECKS = {
    "FS": """pot POTENTIAL { type=EAM; form=FS; rmax=5.5 Angstrom;
  Cu = 0.8 2.0 1.5 5.0 7.0 3.6; Ag = 0.7 2.6 1.6 5.5 7.5 4.1; }""",
    "SC": """pot POTENTIAL { type=EAM; form=SC; rmax=5.5 Angstrom;
  Cu = 0.012 3.61 9 6 39.432; Ag = 0.0025 4.09 12 6 144.41; }""",
    "EXP": """pot POTENTIAL { type=EAM; form=EXP; rmax=5.5 Angstrom;
  atomvolume=11.81 Angstrom^3; phi_e=0.59 eV; r_e=2.556 Angstrom;
  alpha=5.09; beta=5.85; gamma=8.0; E_c=3.54 eV; }""",
    "AT": """pot POTENTIAL { type=EAM; form=AT; rmax=5.5 Angstrom;
  Cu = 1.5 1.0 2.4 1.0 4.5 0.1 -0.02 0.001 4.0;
  Ag = 1.2 0.8 2.6 1.2 4.8 0.08 -0.015 0.0008 4.3; }""",
    "RATIONAL": """pot POTENTIAL { type=EAM; form=RATIONAL; rmax=5.5 Angstrom;
  density_type=elementwise; }
Cu_embedding FIT { cutoff=1e30; orderP=2; orderQ=1; P=0 -0.3 0.002;
  Q=1 0.05; xUnits=NONE; yUnits=eV; }
Ag_embedding FIT { cutoff=1e30; orderP=2; orderQ=1; P=0 -0.25 0.001;
  Q=1 0.04; xUnits=NONE; yUnits=eV; }
Cu_density FIT { cutoff=30.25; orderP=0; orderQ=2; P=167.9616; Q=0 0 1;
  xUnits=Angstrom^2; yUnits=NONE; }
Ag_density FIT { cutoff=28.0; orderP=1; orderQ=2; P=150.0 2.0; Q=0.5 0 1;
  xUnits=Angstrom^2; yUnits=NONE; }
Cu_Cu_2body FIT { cutoff=30.25; orderP=0; orderQ=3; P=26.12; Q=0 0 0 1;
  xUnits=Angstrom^2; yUnits=eV; }
Cu_Ag_2body FIT { cutoff=30.25; orderP=0; orderQ=3; P=30.0; Q=0 0 0 1;
  xUnits=Angstrom^2; yUnits=eV; }
Ag_Ag_2body FIT { cutoff=30.25; orderP=0; orderQ=3; P=35.0; Q=0 0 0 1;
  xUnits=Angstrom^2; yUnits=eV; }""",
}
FORMS = tuple(DECKS)


class _Sp:
    def __init__(self, name):
        self.name = name


def _parms(pkg, form, ns):
    """compile_eam of DECKS[form] over the first ns of (Cu, Ag) in the
    JAX package ("jax") or the port ("torch")."""
    db = JObjectDB() if pkg == "jax" else TObjectDB()
    db.compile_string(DECKS[form])
    compile_eam = jeam.compile_eam if pkg == "jax" else team.compile_eam
    return compile_eam(db, "pot", [_Sp("Cu"), _Sp("Ag")][:ns])


def _alloy_parms():
    """The T = 2 FS alloy with an asymmetric density (b) of
    tests/test_pallas_cellpair.py:test_pallas_eam_alloy_matches_xla: the
    only case that tells rho(t_p, t_q) from rho(t_q, t_p)."""
    eV, Ang, rcut = U.unit_scale("eV"), U.unit_scale("Angstrom"), 0.55
    return jeam.EamParms(
        form="FS", n_species=2, rcut=rcut,
        pair_tables=dict(a=np.array([[0.8, 0.7], [0.7, 0.9]]) * eV,
                         b=np.array([[2.0, 3.5], [1.2, 2.6]]) * eV * eV,
                         c=np.array([[1.5, 1.4], [1.4, 1.6]]) * Ang,
                         m=np.full((2, 2), 5.0), n=np.full((2, 2), 7.0),
                         ro=np.full((2, 2), 1.0) * Ang,
                         x=np.full((2, 2), rcut)),
        embed_tables={})


@pytest.fixture(scope="module")
def crystal_deck(tmp_path_factory):
    """The eam_crystal deck (RATIONAL, nc = 4) written by the JAX
    builder."""
    d = str(tmp_path_factory.mktemp("eam_crystal"))
    j_eam_crystal(d, nc=4)
    return d


# ---------------------------------------------------------------------------
# (a) deck compilation and the builder
# ---------------------------------------------------------------------------

def _assert_parms_equal(tp, jp):
    assert (tp.form, tp.n_species, tp.rcut) == (jp.form, jp.n_species, jp.rcut)
    for tt, jt in ((tp.pair_tables, jp.pair_tables),
                   (tp.embed_tables, jp.embed_tables)):
        assert sorted(tt) == sorted(jt)
        for k in jt:
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)


@pytest.mark.parametrize("form", FORMS)
def test_compile_eam_equals_jax(form):
    for ns in (1, 2):
        _assert_parms_equal(_parms("torch", form, ns), _parms("jax", form, ns))


def test_eam_crystal_deck_and_tables_equal_jax(tmp_path, crystal_deck):
    """The port's eam_crystal writes the JAX builder's files, and
    build_system compiles its RATIONAL tables as the JAX package does."""
    from ddcmd_tpu.core.system import build_system as j_build_system
    from ddcmd_tpu_torch.core.system import build_system as t_build_system

    t_eam_crystal(str(tmp_path), nc=4)
    for name in ("object.data", "atoms#000000"):
        with open(os.path.join(crystal_deck, name)) as a, \
                open(os.path.join(tmp_path, name)) as b:
            assert a.read() == b.read(), name
    jsd = j_build_system(j_load(crystal_deck)[0], crystal_deck)
    tsd = t_build_system(t_load(crystal_deck)[0], crystal_deck)
    assert [p[0] for p in tsd.potentials] == ["EAM"]
    _assert_parms_equal(tsd.potentials[0][2], jsd.potentials[0][2])
    assert tsd.rcut_max == jsd.rcut_max
    assert tsd.bonded is None and tsd.n_constraints == 0
    np.testing.assert_array_equal(tsd.state.species.numpy(),
                                  np.asarray(jsd.state.species))


# ---------------------------------------------------------------------------
# (b) the per-pair forms and the embedding
# ---------------------------------------------------------------------------

def _close(t, j, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert np.isfinite(t).all(), what
    scale = max(np.abs(j).max(), 1e-30)
    np.testing.assert_allclose(t, j, rtol=FORM_RTOL, atol=FORM_RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("form", FORMS)
def test_pair_eval_and_embedding_equal_jax(form):
    """_pair_eval (both derivative orders, gathered pair indices of a
    two-species table) and _embedding on seeded r^2 and rho."""
    parms = _parms("jax", form, 2)
    jt = jeam.eam_device_tables(parms, dtype=jnp.float32)
    tt = team.eam_device_tables(parms)
    rng = np.random.default_rng(5)
    r2 = rng.uniform(0.2 ** 2, 0.55 ** 2, 4096).astype(np.float32)
    ir = (1.0 / np.sqrt(r2)).astype(np.float32)
    ir2 = (1.0 / r2).astype(np.float32)
    idx = rng.integers(0, 4, r2.shape)
    for deriv in (False, True):
        j_out = jeam._pair_eval(form, jt["pair"], jnp.asarray(idx),
                                jnp.asarray(r2), jnp.asarray(ir),
                                jnp.asarray(ir2), deriv)
        t_out = team._pair_eval(form, tt["pair"], torch.tensor(idx),
                                torch.tensor(r2), torch.tensor(ir),
                                torch.tensor(ir2), deriv)
        for k in range(2):
            _close(t_out[k].numpy(), j_out[k], f"{form} deriv={deriv} {k}")
    rho = rng.uniform(0.05, 60.0, 4096).astype(np.float32)
    tid = rng.integers(0, 2, rho.shape)
    j_out = jeam._embedding(form, jt["embed"], jnp.asarray(tid),
                            jnp.asarray(rho))
    t_out = team._embedding(form, tt["embed"], torch.tensor(tid),
                            torch.tensor(rho))
    for k in range(2):
        _close(t_out[k].numpy(), j_out[k], f"{form} embedding {k}")


def test_kernel_params_pack_every_form():
    """eam_kernel_tables' rows unpack to the device tables (RATIONAL: the
    shorter fit zero-padded to the common degree)."""
    for form in FORMS:
        tt = team.eam_device_tables(_parms("torch", form, 2))
        kt = teh.eam_kernel_tables(tt)
        npar = teh.n_params(form, kt["degree"])
        assert kt["params"].shape == (4, npar) and kt["params"].is_contiguous()
        back = teh._unpack(form, kt["params"], kt["degree"])
        for k, v in tt["pair"].items():
            w = back[k].reshape(4, -1)
            v = v.reshape(4, -1)
            torch.testing.assert_close(w[:, :v.shape[1]], v, rtol=0, atol=0)
            assert not w[:, v.shape[1]:].any()
    assert teh.eam_kernel_tables(
        team.eam_device_tables(_parms("torch", "RATIONAL", 2)))["degree"] == 4


# ---------------------------------------------------------------------------
# (c), (d) the twins through eam_eval_half against the Pallas kernels
# ---------------------------------------------------------------------------

def _fcc(a_lat, nside):
    """tests/test_eam.py:fcc."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nside)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    r = (cells[:, None, :] + base[None, :, :]).reshape(-1, 3) * a_lat
    L = a_lat * nside
    return r - L / 2, L


@pytest.fixture(scope="module")
def crystal500():
    """The 500-atom jittered fcc(0.3615, 5) of tests/test_pallas_cellpair
    .py, with random species for the alloy, and its JAX plan and perm."""
    from ddcmd_tpu.ops.cellpair import build_cell_slots

    r, L = _fcc(0.3615, 5)
    rng = np.random.default_rng(17)
    r = (r + rng.standard_normal(r.shape) * 0.006).astype(np.float32)
    n = len(r)
    sidx2 = rng.integers(0, 2, n)
    grid = jpc.plan_lanes([L] * 3, 0.55, 0.1, n)
    perm, ov = build_cell_slots(jnp.asarray(r), jnp.ones(n, jnp.float32),
                                jnp.asarray([L] * 3, jnp.float32), grid)
    assert not bool(ov)
    return r, L, sidx2, grid, np.asarray(perm)


def _case_parms(case, crystal_deck):
    if case == "alloy":
        return _alloy_parms(), True
    if case == "RATIONAL":
        from ddcmd_tpu.core.system import build_system as j_build_system

        sd = j_build_system(j_load(crystal_deck)[0], crystal_deck)
        return sd.potentials[0][2], False
    return _parms("jax", case, 1), False


def _box(L):
    return [L] * 3 if np.isscalar(L) else list(L)


def _jax_eval(r, L, sidx, grid, perm, parms, G, fmask=None):
    tables = jeam.eam_device_tables(parms, dtype=jnp.float32)
    hg = j_half_grid(grid)
    if G > 1:
        rho_fn, force_fn = jpe.make_pallas_eam_col(hg, tables, G,
                                                   interpret=True)
        stencil = jpc.pack_stencil_col(hg, G)
    else:
        rho_fn, force_fn = jpe.make_pallas_eam(hg, tables, interpret=True)
        stencil = jpc.pack_stencil(hg)
    fmask = np.ones(len(r), np.float32) if fmask is None else fmask
    out = jpe.pallas_eam_eval(jnp.asarray(r), jnp.asarray(sidx, jnp.int32),
                              jnp.asarray(fmask, jnp.float32),
                              jnp.asarray(perm),
                              jnp.asarray(_box(L), jnp.float32), hg, tables,
                              jnp.asarray(stencil), rho_fn, force_fn)
    return tuple(np.asarray(x, np.float64) for x in out)


def _port_eval(r, L, sidx, perm, parms, G, fmask=None, tg=None):
    n = len(r)
    if tg is None:
        tg = tch.plan_lanes(_box(L), 0.55, 0.1, n)
    fmask = torch.ones(n) if fmask is None else torch.tensor(fmask)
    hg = tcp.half_grid(tg)
    gt = tch.grid_tensors(hg, "cpu", G)
    tables = teh.eam_kernel_tables(team.eam_device_tables(parms))
    counters = [k.launches for k in (teh.eam_rho_half, teh.eam_force_half,
                                     teh.eam_rho_half_col,
                                     teh.eam_force_half_col)]
    out = teh.eam_eval_half(torch.tensor(r), torch.tensor(sidx),
                            fmask, torch.tensor(perm),
                            torch.tensor(_box(L), dtype=torch.float32), hg,
                            tables, gt)
    # CPU tensors: the twins ran, no kernel launched
    assert counters == [k.launches for k in (
        teh.eam_rho_half, teh.eam_force_half, teh.eam_rho_half_col,
        teh.eam_force_half_col)]
    return tuple(x.numpy().astype(np.float64) for x in out)


def _assert_eval_close(t, j):
    (tf, te, tv, tpe), (jf, je, jv, jpe_) = t, j
    assert np.isfinite(tf).all() and np.isfinite(te)
    assert te == pytest.approx(je, rel=E_REL)
    scale = max(1.0, np.abs(jf).max())
    assert np.abs(tf - jf).max() / scale < F_REL
    assert tv == pytest.approx(jv, rel=V_REL, abs=V_ABS)
    # per-particle energy: the same sums as e, held at e's tolerance of
    # the largest |pe|
    assert np.abs(tpe - jpe_).max() <= E_REL * np.abs(jpe_).max()
    assert tpe.sum() == pytest.approx(te, rel=1e-5)


@pytest.mark.parametrize("case", FORMS + ("alloy",))
def test_percell_twins_match_pallas_interpret(case, crystal500, crystal_deck):
    """eam_eval_half on the per-cell twins == pallas_eam_eval with
    make_pallas_eam (interpret mode), every analytic form and the
    asymmetric T = 2 alloy."""
    r, L, sidx2, grid, perm = crystal500
    parms, alloy = _case_parms(case, crystal_deck)
    sidx = sidx2 if alloy else np.zeros(len(r), np.int64)
    assert tch.choose_col_group(tcp.half_grid(
        tch.plan_lanes([L] * 3, 0.55, 0.1, len(r)))) == 1
    _assert_eval_close(_port_eval(r, L, sidx, perm, parms, 1),
                       _jax_eval(r, L, sidx, grid, perm, parms, 1))


@pytest.mark.parametrize("case", ["FS", "RATIONAL", "alloy"])
def test_col_twins_match_pallas_interpret(case, crystal500, crystal_deck):
    """The column twins (G = 2 on the (2, 2, 2) grid, nz == G: an aliased
    union) == make_pallas_eam_col in interpret mode."""
    r, L, sidx2, grid, perm = crystal500
    assert grid.ncells == (2, 2, 2)
    parms, alloy = _case_parms(case, crystal_deck)
    sidx = sidx2 if alloy else np.zeros(len(r), np.int64)
    _assert_eval_close(_port_eval(r, L, sidx, perm, parms, 2),
                       _jax_eval(r, L, sidx, grid, perm, parms, 2))


@pytest.fixture(scope="module")
def ragged():
    """chip_smoke.ragged_system(): cells of 0, 1, 31, 32, 33 and cap live
    slots, a tenth of the atoms masked inside the counts -- the case the
    card's kernel-vs-plain comparison runs -- with the JAX package's grid
    of the same shape and its perm (binned unmasked, so the masked atoms
    keep their slots)."""
    import chip_smoke
    from ddcmd_tpu.ops.cellpair import (CellBlockGrid, _build_stencil,
                                        build_cell_slots)

    r, L, sidx2, fmask, tg = chip_smoke.ragged_system()
    jg = CellBlockGrid(tg.ncells, tg.cap, tg.rlist, *_build_stencil(tg.ncells))
    perm, ov = build_cell_slots(jnp.asarray(r), jnp.ones(len(r), jnp.float32),
                                jnp.asarray(L, jnp.float32), jg)
    assert not bool(ov)
    perm = np.asarray(perm)
    tperm, tov = tcp.build_cell_slots(torch.tensor(r), torch.ones(len(r)),
                                      torch.tensor(L, dtype=torch.float32), tg)
    assert not bool(tov) and np.array_equal(tperm.numpy(), perm)
    counts = (perm.reshape(tg.ncell, tg.cap) != len(r)).sum(1)
    assert sorted(set(counts.tolist())) == [*chip_smoke.RAGGED_COUNTS, tg.cap]
    assert 0 < (fmask == 0).sum() < len(r) // 5
    return r, L, sidx2, fmask, tg, jg, perm


@pytest.mark.parametrize("case,G", [("RATIONAL", 1), ("RATIONAL", 2),
                                    ("alloy", 4)])
def test_ragged_twins_match_pallas_interpret(case, G, ragged, crystal_deck):
    """The per-cell (G = 1) and column plain versions == the Pallas
    kernels in interpret mode on the ragged occupancy, so the card's
    comparison of the CUDA kernels on this case rests on a twin that is
    itself held to the JAX package here."""
    r, L, sidx2, fmask, tg, jg, perm = ragged
    parms, alloy = _case_parms(case, crystal_deck)
    sidx = sidx2 if alloy else np.zeros(len(r), np.int64)
    _assert_eval_close(
        _port_eval(r, L, sidx, perm, parms, G, fmask=fmask, tg=tg),
        _jax_eval(r, L, sidx, jg, perm, parms, G, fmask=fmask))


# ---------------------------------------------------------------------------
# (e) the slice's two plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nc,ncells,G,U", [(12, (4, 5, 5), 1, None),
                                           (32, (11, 12, 12), 4, 29)])
def test_crystal_plans(nc, ncells, G, U, monkeypatch):
    """nc = 12 (6,912 atoms) stays on the per-cell kernels; nc = 32
    (131,072 atoms) takes the column kernels at G = 4, U = 29, whose
    force pass fits in shared memory (the fit rule keeps G).  Both plans
    equal the JAX package's."""
    for k in ("DDCMD_PALLAS_COLS", "DDCMD_PALLAS_VARIANT"):
        monkeypatch.delenv(k, raising=False)
    L = [nc * 0.3615] * 3
    n = 4 * nc ** 3
    jg = jpc.plan_lanes(L, 0.55, 0.1, n)
    tg = tch.plan_lanes(L, 0.55, 0.1, n)
    assert (tg.ncells, tg.cap) == (jg.ncells, jg.cap) == (ncells, 128)
    th = tcp.half_grid(tg)
    assert tch.choose_col_group(th) == jpc.choose_col_group(j_half_grid(jg)) == G
    npar = teh.n_params("RATIONAL", 4)
    fit = tch.fit_col_group(th, G, lambda u: teh.eam_col_smem_bytes(
        u, th.cap, 1, npar))
    assert fit == G
    if U is not None:
        assert len(tch.col_plan_grid(th, G)[0]) == U
        assert teh.eam_col_smem_bytes(U, 128, 1, npar) == 72_620


# ---------------------------------------------------------------------------
# (f) the slice end to end
# ---------------------------------------------------------------------------

def test_slice_matches_jax_cellblock_f64(crystal_deck):
    """The port's Simulation on eam_crystal(nc = 4) (plain twins on the
    CPU): first energy, forces and virial against the JAX package's f64
    cell-block engine, then 10 steps finite."""
    from ddcmd_tpu.run.simulate import Simulation as JSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

    d = crystal_deck
    jsim = JSimulation(*j_load(d), run_dir=d, engine="cellblock",
                       dtype=jnp.float64)
    tsim = TSimulation(*t_load(d), run_dir=d, device="cpu")
    term = tsim.force_fn.terms[0]
    assert term.G == 1 and tsim.grid.ncells == (1, 2, 2)
    jsim.first_energy()
    tsim.first_energy()
    je, te = jsim.ss.energy, tsim.ss.energy
    assert float(te.eion) == pytest.approx(float(je.eion), rel=E_REL)
    fj = np.asarray(jsim.ss.state.f)
    scale = max(1.0, np.abs(fj).max())
    assert np.abs(tsim.ss.state.f.numpy() - fj).max() / scale < F_REL
    assert tsim.ss.energy.virial.numpy() == pytest.approx(
        np.asarray(je.virial), rel=V_REL, abs=V_ABS)
    rows = []
    tsim.run(10, print_fn=rows.append)
    assert tsim.ss.loop == 10
    assert np.isfinite(float(tsim.ss.energy.eion))
    assert np.isfinite(tsim.ss.state.r.numpy()).all()


def test_unsupported_eam_raises(tmp_path, crystal_deck):
    """An EAM deck the kernels do not take -- a TABULAR deck without a
    refit, a five-species alloy -- runs on the plain cell-block EAM
    engine under auto; an explicit engine="kernel" raises ValueError
    naming that engine instead of moving off the kernels unasked."""
    import chip_smoke
    from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
    from ddcmd_tpu_torch.run.forces import _eam_term

    for name, make in (("tab", chip_smoke.tabular_eam_deck),
                       ("five", chip_smoke.alloy_eam_deck)):
        d = str(tmp_path / name)
        os.mkdir(d)
        make(d, 2, 100)
        assert TSimulation(*t_load(d), run_dir=d, device="cpu").engine \
            == "cellblock"
        with pytest.raises(ValueError, match="'kernel'.*EAM form"):
            TSimulation(*t_load(d), run_dir=d, device="cpu", engine="kernel")
    p = _alloy_parms()
    five = team.EamParms("FS", 5, p.rcut,
                         {k: np.ones((5, 5)) for k in p.pair_tables}, {})
    grid = tch.plan_lanes([1.8] * 3, 0.55, 0.1, 500)
    with pytest.raises(ValueError, match="5 species.*'cellblock'"):
        _eam_term(five, grid, "kernel", 7, torch.float32, "cpu")
