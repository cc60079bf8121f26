"""Slice 12, the (N,K)-list engine's terms against the JAX package's, in
float64 on the same neighbor list (the port's, which equals JAX's in
f64: tests/test_torch_nlist.py): pair_lj (Lennard-Jones at T = 1
and T = 2, and the TableFunction), martini_nonbond with the in-list
exclusion table, eam_eval (FS, RATIONAL, TABULAR, the tabularFit=
rational refit, a T = 2 alloy with an asymmetric density, a triclinic
box), pairenergy_eval (T = 1 and 2) and the ORDERSH bias (phi, its
autograd forces, sqrt(phi) = 0.57452 on ideal FCC, finite differences),
and write_qlocal_files byte for byte.

Tolerances: forces within 1e-9 of the force scale, energies rel 1e-12,
virial and per-particle energies rel 1e-9 (abs 1e-9 of their scale):
both packages run the same f64 expressions in the same order, and only
the order of their reductions differs.  Finite differences of the
ORDERSH energy: rel 1e-5, abs 1e-6 (tests/test_eam.py:269-300).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import lj_fluid as j_lj_fluid
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.objects import ObjectDB as JObjectDB
from ddcmd_tpu.potentials import eam as jeam
from ddcmd_tpu.potentials import martini as jmar
from ddcmd_tpu.potentials import ordersh as josh
from ddcmd_tpu.potentials import pair as jpair
from ddcmd_tpu.potentials import pairenergy as jpen
from ddcmd_tpu.run.forces import _excl_table as j_excl_table
from ddcmd_tpu_torch.core.system import build_system as t_build_system
from ddcmd_tpu_torch.models import lj_fluid as t_lj_fluid
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.nbr import celllist as tcl
from ddcmd_tpu_torch.objects import ObjectDB as TObjectDB
from ddcmd_tpu_torch.potentials import eam as team
from ddcmd_tpu_torch.potentials import martini as tmar
from ddcmd_tpu_torch.potentials import ordersh as tosh
from ddcmd_tpu_torch.potentials import pair as tpair
from ddcmd_tpu_torch.potentials import pairenergy as tpen
from ddcmd_tpu_torch.run.forces import _excl_table as t_excl_table
from test_torch_bonded import systems  # noqa: F401
from test_torch_eam import _alloy_parms, _fcc, _parms
from test_torch_tabular_eam import decks, parms  # noqa: F401

torch.set_num_threads(2)

F_REL, E_REL, V_REL = 1e-9, 1e-12, 1e-9
OSH_DECK = ("osh POTENTIAL { type=ORDERSH; L=6; r1o=2.6 Angstrom; "
            "r2o=3.0 Angstrom; lamda=1.0 kJ/mol; }")
PEN_DECK = ("pot POTENTIAL { type=PAIRENERGY; rmax=5.5 Angstrom; "
            "r_expansion=5.5 Angstrom; Cu-Cu_2body= 0.0 0.05 -0.002 0.0001 ; "
            "Ag-Ag_2body= 0.0 0.04 -0.001 ; Cu-Ag_2body= 0.01 0.045 ; }")


class _Sp:
    def __init__(self, name):
        self.name = name


def _perp(h):
    a = np.asarray(h).T
    v = abs(np.linalg.det(h))
    return np.array([v / np.linalg.norm(np.cross(a[(i + 1) % 3],
                                                  a[(i + 2) % 3]))
                     for i in range(3)])


def _crystal(nc, tilt=0.0, seed=2, jitter=0.006):
    """A jittered fcc copper crystal of nc^3 cells: (r, geom), geom the
    (3,) lengths or, with a tilt, a monoclinic (3,3) h."""
    r, L = _fcc(0.3615, nc)
    h = np.diag([L, L, L])
    h[0, 1] = tilt * L
    r = (r / L) @ h.T
    rng = np.random.default_rng(seed)
    r = r + rng.standard_normal(r.shape) * jitter
    return r, (np.diag(h).copy() if tilt == 0.0 else h)


def _jlist(r, geom, rlist, fmask=None):
    """The f64 (N,K) list of r within rlist (numpy), from the port's
    build_neighbor_list."""
    n = len(r)
    geom = np.asarray(geom, np.float64)
    span = geom if geom.ndim == 1 else _perp(geom)
    grid = tcl.CellGrid.plan(span, rlist, 0.0, n, n)
    fm = np.ones(n) if fmask is None else fmask
    nbr, _, ov = tcl.build_neighbor_list(_t(r), _t(fm), _t(geom), grid)
    assert not bool(ov)
    return nbr.numpy()


def _close(t, j):
    """(f, e, virial, pe) of the port (torch) against JAX's (arrays)."""
    tf, te, tv, tpe = (np.asarray(x) for x in t[:4])
    jf, je, jv, jpe = (np.asarray(x) for x in j[:4])
    assert np.isfinite(tf).all() and np.abs(jf).max() > 0
    assert np.abs(tf - jf).max() <= F_REL * max(1.0, np.abs(jf).max())
    assert float(te) == pytest.approx(float(je), rel=E_REL)
    np.testing.assert_allclose(tv, jv, rtol=V_REL,
                               atol=V_REL * max(1e-30, np.abs(jv).max()))
    np.testing.assert_allclose(tpe, jpe, rtol=V_REL,
                               atol=V_REL * max(1e-30, np.abs(jpe).max()))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------------
# pair_lj
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table_decks(tmp_path_factory):
    """The 500-atom TableFunction fluid in both packages' builders:
    (jax parms, port parms, positions, box lengths)."""
    dj = str(tmp_path_factory.mktemp("jtab"))
    dt = str(tmp_path_factory.mktemp("ttab"))
    j_lj_fluid(dj, n=500, table=True)
    t_lj_fluid(dt, n=500, table=True)
    jsd = j_build_system(j_load(dj)[0], dj)
    tsd = t_build_system(t_load(dt)[0], dt)
    n = jsd.state.n_local
    return (jsd.potentials[0][2], tsd.potentials[0][2],
            np.asarray(jsd.state.r[:n], np.float64),
            np.asarray(jsd.box.lengths, np.float64))


def _lj_parms(ns):
    """compile_pair of a T = ns LJ deck (per-pair PAIRPARMS) in the JAX
    package, and the same deck in the port."""
    deck = ("pot POTENTIAL { type=PAIR; function=lennardjones; "
            "cutoff=0.85 nm; }\n"
            "A-A PAIRPARMS { eps=1.0 kJ/mol; sigma=0.34 nm; }\n"
            "B-B PAIRPARMS { eps=1.4 kJ/mol; sigma=0.30 nm; }\n"
            "A-B PAIRPARMS { eps=1.2 kJ/mol; sigma=0.32 nm; }\n")
    sp = [_Sp("A"), _Sp("B")][:ns]
    return (jpair.compile_pair(JObjectDB().compile_string(deck), "pot", sp),
            tpair.compile_pair(TObjectDB().compile_string(deck), "pot", sp))


@pytest.mark.parametrize("case", ["lj1", "lj2", "table"])
def test_pair_lj_matches_jax(case, table_decks):
    """pair_lj (LJ over one and two species, the TableFunction's cubic
    rows) == the JAX package's on its f64 list; the port's tables of the
    table deck equal JAX's."""
    rng = np.random.default_rng(4)
    if case == "table":
        jp, tp, r, L = table_decks
        assert tp.table is not None
        for k in ("x", "coeff"):
            np.testing.assert_array_equal(tp.table[k], jp.table[k])
    else:
        jp, tp = _lj_parms(int(case[-1]))
        r, L = _crystal(4, jitter=0.02)
        L = L * 1.4
        r = r * 1.4
    n = len(r)
    sidx = rng.integers(0, jp.n_species, n)
    fmask = (rng.random(n) > 0.05).astype(np.float64)
    nbr = _jlist(r, L, jp.rcut + 0.1, fmask)
    jt = jpair.pair_device_tables(jp, jnp.float64)
    j = jpair.pair_lj(jnp.asarray(r), jnp.asarray(sidx), jnp.asarray(fmask),
                      jnp.asarray(nbr), jnp.asarray(L), jt)
    for p in (tp, jp):
        tt = tpair.pair_device_tables(p, torch.float64)
        t = tpair.pair_lj(_t(r), torch.tensor(sidx), _t(fmask),
                          torch.tensor(nbr), _t(L), tt)
        _close(t, j)


# ---------------------------------------------------------------------------
# martini_nonbond with the in-list exclusion table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", ["bilayer", "triclinic"])
def test_martini_nonbond_matches_jax(geom, systems):  # noqa: F811
    """martini_nonbond == the JAX package's in f64: the small bilayer
    (five LJ types, reaction field) with its excluded pairs masked in the
    list through _excl_table (equal to JAX's), and a charged two-type
    system in a monoclinic box."""
    jsd, tsd, _ = systems
    if geom == "bilayer":
        jp = jsd.potentials[0][2]
        n, n_pad = jsd.state.n_local, jsd.state.n_pad
        r = np.asarray(jsd.state.r, np.float64)
        q = np.asarray(jsd.state.q, np.float64)
        tidx = np.asarray(jp.species_lj_type)[np.asarray(jsd.state.species)]
        fmask = np.asarray(jsd.state.fmask, np.float64)
        g = np.asarray(jsd.box.lengths, np.float64)
        jtab = jmar.martini_device_tables(jp, jnp.float64)
        ttab = tmar.martini_device_tables(tsd.potentials[0][2],
                                          torch.float64)
        ex = jsd.bonded.exclusions
        excl = t_excl_table(ex, n_pad)
        np.testing.assert_array_equal(excl, j_excl_table(ex, n_pad))
        assert excl.shape[1] > 1 and (excl[:n] != n_pad).any()
    else:
        r, q, tidx, tables, rcut = chip_smoke.synthetic(400, 2.8, seed=5)
        n = len(r)
        g = np.diag([2.8, 2.8, 2.8])
        g[0, 1] = 0.5
        r = r @ np.linalg.inv(np.diag([2.8] * 3)) @ g.T
        fmask = np.ones(n)
        jtab = {k: jnp.asarray(v, jnp.float64) for k, v in tables.items()}
        ttab = {k: (_t(v) if np.ndim(v) else float(v))
                for k, v in tables.items()}
        excl = None
    nbr = _jlist(r, g, 1.2, fmask)
    j = jmar.martini_nonbond(
        jnp.asarray(r), jnp.asarray(q), jnp.asarray(tidx), jnp.asarray(fmask),
        jnp.asarray(nbr), jnp.asarray(g), jtab,
        excl_tbl=None if excl is None else jnp.asarray(excl))
    t = tmar.martini_nonbond(
        _t(r), _t(q), torch.tensor(tidx), _t(fmask), torch.tensor(nbr), _t(g),
        ttab, excl_tbl=None if excl is None else torch.tensor(excl))
    _close(t, j)
    for a, b in zip(t[4], j[4]):
        assert float(a) == pytest.approx(float(b), rel=E_REL, abs=1e-9)


# ---------------------------------------------------------------------------
# eam_eval
# ---------------------------------------------------------------------------

EAM_CASES = [("fs", "ortho"), ("rat", "ortho"), ("tab", "ortho"),
             ("fit", "ortho"), ("alloy", "ortho"), ("rat", "triclinic"),
             ("alloy", "triclinic")]


@pytest.mark.parametrize("case,geom", EAM_CASES)
def test_eam_eval_matches_jax(case, geom, parms):  # noqa: F811
    """eam_eval == the JAX package's in f64 on a jittered crystal with
    random species and a tenth of the rows masked: FS, the crystal's
    RATIONAL, TABULAR, the refit, the asymmetric T = 2 alloy (the
    transposed density derivative); orthorhombic and monoclinic (tilt
    0.2); eam_device_tables of either package's parms."""
    p, T = {"fs": lambda: (_parms("jax", "FS", 1), 1),
            "alloy": lambda: (_alloy_parms(), 2)}.get(
        case, lambda: (parms[case, "jax"], 1))()
    r, g = _crystal(4, tilt=0.2 if geom == "triclinic" else 0.0)
    n = len(r)
    rng = np.random.default_rng(9)
    sidx = rng.integers(0, T, n)
    fmask = (rng.random(n) > 0.1).astype(np.float64)
    nbr = _jlist(r, g, p.rcut + 0.05)
    j = jeam.eam_eval(jnp.asarray(r), jnp.asarray(sidx), jnp.asarray(fmask),
                      jnp.asarray(nbr), jnp.asarray(g),
                      jeam.eam_device_tables(p, dtype=jnp.float64))
    t = team.eam_eval(_t(r), torch.tensor(sidx), _t(fmask),
                      torch.tensor(nbr), _t(g),
                      team.eam_device_tables(p, dtype=torch.float64))
    _close(t, j)


# ---------------------------------------------------------------------------
# PAIRENERGY
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ns", [1, 2])
def test_pairenergy_matches_jax(ns):
    """compile_pairenergy (host, copied) == JAX's, and pairenergy_eval ==
    JAX's in f64 on the JAX list (tests/test_eam.py:236's series; a T = 2
    variant with a cross series)."""
    sp = [_Sp("Cu"), _Sp("Ag")][:ns]
    jp = jpen.compile_pairenergy(JObjectDB().compile_string(PEN_DECK),
                                 "pot", sp)
    tp = tpen.compile_pairenergy(TObjectDB().compile_string(PEN_DECK),
                                 "pot", sp)
    np.testing.assert_array_equal(tp.coeffs, jp.coeffs)
    assert (tp.r2_expansion, tp.rcut) == (jp.r2_expansion, jp.rcut)
    r, L = _crystal(4, jitter=0.01)
    rng = np.random.default_rng(3)
    sidx = rng.integers(0, ns, len(r))
    fmask = np.ones(len(r))
    nbr = _jlist(r, L, jp.rcut + 0.05)
    j = jpen.pairenergy_eval(
        jnp.asarray(r), jnp.asarray(sidx), jnp.asarray(fmask),
        jnp.asarray(nbr), jnp.asarray(L),
        jpen.pairenergy_device_tables(jp, jnp.float64))
    t = tpen.pairenergy_eval(
        _t(r), torch.tensor(sidx), _t(fmask), torch.tensor(nbr), _t(L),
        tpen.pairenergy_device_tables(tp, torch.float64))
    _close(t, j)


# ---------------------------------------------------------------------------
# ORDERSH
# ---------------------------------------------------------------------------

def _osh_parms():
    jp = josh.compile_ordersh(JObjectDB().compile_string(OSH_DECK), "osh")
    tp = tosh.compile_ordersh(TObjectDB().compile_string(OSH_DECK), "osh")
    assert vars(tp) == vars(jp)
    return jp, tp


def test_ordersh_ideal_fcc_and_jax():
    """The ORDERSH bias on ideal FCC: sqrt(phi) = 0.57452 (the JAX
    package's tests/test_eam.py value), phi, energy and forces equal
    JAX's in f64 on a jittered crystal with masked rows, the forces
    (autograd) equal finite differences of the energy, the virial is zero
    and pe is e/N on the valid rows."""
    jp, tp = _osh_parms()
    r, L = _fcc(0.3615, 3)
    n = len(r)
    fm = np.ones(n)
    ev = tosh.make_ordersh_eval(tp, n, torch.float64)
    nbr = _jlist(r, [L] * 3, tp.r2o + 0.05)
    out = ev(_t(r), _t(fm), torch.tensor(nbr), _t([L] * 3))
    assert float(torch.sqrt(out[4])) == pytest.approx(0.57452, abs=2e-4)

    rng = np.random.default_rng(0)
    rd = r + rng.standard_normal(r.shape) * 0.02
    fm = (rng.random(n) > 0.1).astype(np.float64)
    nbr = _jlist(rd, [L] * 3, tp.r2o + 0.05, fm)
    # jitted: one compile instead of the eager complex ops' many
    j = jax.jit(josh.make_ordersh_eval(jp, n, jnp.float64))(
        jnp.asarray(rd), jnp.asarray(fm), jnp.asarray(nbr),
        jnp.asarray([L] * 3))
    args = (_t(fm), torch.tensor(nbr), _t([L] * 3))
    t = ev(_t(rd), *args)
    _close(t, j)
    assert float(t[4]) == pytest.approx(float(j[4]), rel=E_REL)
    assert not t[2].any()
    np.testing.assert_allclose(t[3].numpy(), float(t[1]) / fm.sum() * fm,
                               rtol=1e-14)
    h = 1e-7
    for i in (0, 41):
        for ax in range(3):
            rp, rm = rd.copy(), rd.copy()
            rp[i, ax] += h
            rm[i, ax] -= h
            fd = -(float(ev(_t(rp), *args)[1])
                   - float(ev(_t(rm), *args)[1])) / (2 * h)
            assert float(t[0][i, ax]) == pytest.approx(fd, rel=1e-5,
                                                       abs=1e-6)


def test_write_qlocal_files_equal_jax(tmp_path):
    """write_qlocal_files (host numpy on the port's f32 list) writes the
    JAX package's q6#000000, q4#000000 and cluster.000000 byte for byte
    on a slightly jittered 4x4x4 crystal (L = 6 4, clusterWrite=1)."""
    deck = OSH_DECK.replace("L=6;", "L=6 4; clusterWrite=1;")
    jp = josh.compile_ordersh(JObjectDB().compile_string(deck), "osh")
    tp = tosh.compile_ordersh(TObjectDB().compile_string(deck), "osh")
    assert tp.L_list == (6, 4) and tp.cluster_write
    r, g = _crystal(4, jitter=0.004, seed=11)
    r, L = r.astype(np.float32), g[0]
    n = len(r)
    gid = np.arange(n, dtype=np.uint64) + 7

    def sim(pkg, p):
        arr = jnp.asarray if pkg == "jax" else torch.tensor
        return SimpleNamespace(
            sysdef=SimpleNamespace(potentials=[("ORDERSH", "osh", p)],
                                   state=SimpleNamespace(n_local=n),
                                   collection=SimpleNamespace(gid=gid)),
            ss=SimpleNamespace(state=SimpleNamespace(r=arr(r)), loop=40,
                               box=SimpleNamespace(lengths=arr(
                                   np.float32([L] * 3)))))

    out = {}
    for pkg, p, mod in (("jax", jp, josh), ("torch", tp, tosh)):
        d = tmp_path / pkg
        d.mkdir()
        mod.write_qlocal_files(sim(pkg, p), str(d))
        out[pkg] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert sorted(out["torch"]) == ["cluster.000000", "q4#000000",
                                    "q6#000000"]
    assert out["torch"] == out["jax"]
    assert out["torch"]["cluster.000000"].count(b"# cluster") >= 1
