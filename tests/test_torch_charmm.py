"""Slice 13, the CHARMM all-atom force field, host and evaluators,
against the JAX package: the RTF/PAR readers, compile_charmm (nonbond
tables, species maps, residue templates with their terminal patches),
build_system with the chain links and CMAP, the generic per-term
evaluator bonded_eval for every family (also with per-family weights on
coincident rows), the batched evaluator plus the leftover against
the generic one, and the mesh's resolved batched evaluation (ownership
weights, sanitized torsions), on the c36 solvated tripeptide
(tests/test_charmm_c36.py:make_solvated_fixture, L = 20 A, max_w = 24),
the ethane fluid (tests/test_charmm.py:make_fixture) and the 3-residue
chain with terminal patches (make_ter_fixture).
tests/test_torch_charmm_decks.py runs the decks.

Tolerances: readers, tables and topology exact; in f64 the energies rel
1e-9 and forces, virials and per-particle energies 1e-9 of their scale;
the port in f32 against JAX's f64 on the same (f32) positions 2e-5 of
the force scale and e rel 1e-5 (the LJ gates of the kernels).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_charmm import make_fixture, make_ter_fixture
from test_charmm_c36 import DATA, make_solvated_fixture

from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.potentials import bonded as jb
from ddcmd_tpu.potentials import charmm as jch
from ddcmd_tpu.potentials import charmmfiles as jcf
from ddcmd_tpu_torch.core.system import build_system as t_build_system
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.potentials import bonded as tb
from ddcmd_tpu_torch.potentials import bonded_batch as tbb
from ddcmd_tpu_torch.potentials import charmm as tch
from ddcmd_tpu_torch.potentials import charmmfiles as tcf

torch.set_num_threads(2)

FAMILY_KEYS = ("bonds", "angles", "torsions", "impropers", "bpairs",
               "exclusions", "cmap_atoms")
BT_FIELDS = [f.name for f in dataclasses.fields(jb.BondedTerms)]


def _systems(d):
    """(JAX SystemDef, port SystemDef) of the deck in d, in f64."""
    return (j_build_system(j_load(d)[0], d, dtype=jnp.float64),
            t_build_system(t_load(d)[0], d, dtype=torch.float64))


@pytest.fixture(scope="module")
def c36(tmp_path_factory):
    """(JAX SystemDef, port SystemDef) of the c36 tripeptide."""
    d = tmp_path_factory.mktemp("c36")
    make_solvated_fixture(d, L=20.0, max_w=24)
    return _systems(str(d))


def _deck(kind, d):
    if kind == "c36":
        make_solvated_fixture(d, L=20.0, max_w=24)
    else:
        (make_fixture if kind == "ethane" else make_ter_fixture)(d)
    return str(d)


def _files(kind, d):
    if kind == "c36":
        return (os.path.join(DATA, "c36ish_prot.rtf"),
                os.path.join(DATA, "c36ish_prot.prm"))
    return os.path.join(d, "top.rtf"), os.path.join(d, "par.prm")


def _same(a, b, where):
    """Deep equality of the readers' and compiler's host values; arrays
    element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b and type(a) is type(b), (where, a, b)


# ---------------------------------------------------------------------------
# host: readers, compiler, chain links, build_system
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["c36", "ethane", "chain"])
def test_readers_equal_jax(tmp_path, kind):
    rtf, prm = _files(kind, _deck(kind, tmp_path))
    _same(tcf.read_rtf(rtf), jcf.read_rtf(rtf), "rtf")
    _same(tcf.read_par(prm), jcf.read_par(prm), "par")


@pytest.mark.parametrize("kind", ["c36", "ethane", "chain"])
def test_compile_charmm_equal_jax(tmp_path, kind):
    """sigma / eps / shift, krf / crf, the species maps and every residue
    template (terminal variants included): equal to JAX's."""
    d = _deck(kind, tmp_path)
    jp, jres = jch.compile_charmm(j_load(d)[0], "charmm", d)
    tp, tres = tch.compile_charmm(t_load(d)[0], "charmm", d)
    for k in ("n_types", "sigma", "eps", "shift", "rcut", "rcoulomb",
              "epsilon_r", "epsilon_rf", "krf", "crf", "type_names",
              "species_to_type", "species_mass", "species_charge"):
        _same(getattr(tp, k), getattr(jp, k), k)
    assert list(tres) == list(jres)
    for k in jres:
        _same(tres[k], jres[k], k)


@pytest.mark.parametrize("kind", ["c36", "chain"])
def test_chain_links_equal_jax(tmp_path, kind):
    """build_system: the species' masses and charges, the residue
    instances and, after add_chain_links, every BondedTerms array (CMAP
    atoms, grids and y1 / y2 / y12 maps included): equal to JAX's."""
    jsd, tsd = _systems(_deck(kind, tmp_path))
    assert tsd.residue_instances == jsd.residue_instances
    assert [(s.name, s.mass, s.charge) for s in tsd.species] == \
        [(s.name, s.mass, s.charge) for s in jsd.species]
    np.testing.assert_array_equal(tsd.state.q.numpy(), np.asarray(jsd.state.q))
    np.testing.assert_array_equal(tsd.state.mass.numpy(),
                                  np.asarray(jsd.state.mass))
    for k in BT_FIELDS:
        a, b = getattr(tsd.bonded, k), getattr(jsd.bonded, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)
    assert tsd.bonded.counts() == jsd.bonded.counts()
    assert tsd.bonded.counts()["cmaps"] == 1


# ---------------------------------------------------------------------------
# the evaluators
# ---------------------------------------------------------------------------

def _tables(sd, mod, dtype):
    mp = sd.potentials[0][2]
    kw = {} if mod is jb else {"device": "cpu"}
    return mod.device_bonded_tables(
        sd.bonded, dtype, lj_sigma=mp.sigma, lj_eps=mp.eps,
        lj_shift=mp.shift, rcut=mp.rcut, keR=U.ke / mp.epsilon_r,
        charges=np.asarray(sd.state.q), species_lj_type=mp.species_lj_type,
        species_per_particle=np.asarray(sd.state.species),
        excl_mode="rf_add", krf=mp.krf, crf=mp.crf, **kw)


def _positions(sd, dtype, seed=5, jitter=0.003):
    """The deck's positions jittered by `jitter` nm (numpy seed), rounded
    to dtype."""
    r = sd.state.r.numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(r + rng.standard_normal(r.shape) * jitter,
                           dtype=dtype)


def _close(got, ref, tol, what):
    """got within tol of ref's scale (max |ref|, at least 1e-12)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _both_evals(c36, dtype=torch.float64, only=None, weights=None):
    """JAX's bonded_eval in f64 and the port's in dtype on the c36 tables
    at the same positions (rounded to dtype), restricted to the families
    in `only`, with `weights` {family: (T,) array} whose zero terms point
    at one row."""
    jsd, tsd = c36
    jt = _tables(jsd, jb, jnp.float64)
    tt = _tables(tsd, tb, dtype)
    if only is not None:
        for t in (jt, tt):
            for k in FAMILY_KEYS:
                if k not in only:
                    t.pop(k, None)
    for k, w in (weights or {}).items():
        idx = tt[k].numpy().copy()
        idx[w == 0] = 0
        jt[k], jt[k + "_w"] = jnp.asarray(idx), jnp.asarray(w)
        tt[k], tt[k + "_w"] = (torch.as_tensor(idx),
                               torch.as_tensor(w, dtype=dtype))
    r = _positions(tsd, dtype)
    L = tsd.box.lengths
    n_pad = tsd.state.n_pad
    # jitted: one compile a case instead of the eager ops' many
    jout = jax.jit(lambda r, L: jb.bonded_eval(r, L, jt, n_pad, jnp.float64))(
        jnp.asarray(r.double().numpy()), jnp.asarray(L.numpy()))
    tout = tb.bonded_eval(r, L.to(dtype), tt, n_pad, dtype)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


@pytest.mark.parametrize("family", ("all",) + FAMILY_KEYS)
def test_bonded_eval_equals_jax(c36, family):
    """The generic evaluator, all families together and family by family,
    in f64: forces, energy, virial and per-particle energies within 1e-9
    of their scale; e == sum(pe)."""
    only = None if family == "all" else (family,)
    (jf, je, jv, jpe), (tf, te, tv, tpe) = _both_evals(c36, only=only)
    assert abs(float(je)) > 0
    _close(tf, jf, 1e-9, "f")
    _close(te, je, 1e-9, "e")
    _close(tv, jv, 1e-9, "virial")
    _close(tpe, jpe, 1e-9, "pe")
    assert float(tpe.sum()) == pytest.approx(float(te), rel=1e-12,
                                             abs=1e-9)


def test_bonded_eval_f32(c36):
    """The port in f32 against JAX's f64 on the same f32 positions: 2e-5
    of the force scale, e rel 1e-5, virial 2e-5 of its scale."""
    (jf, je, jv, _), (tf, te, tv, _) = _both_evals(c36, torch.float32)
    _close(tf, jf, 2e-5, "f")
    assert float(te) == pytest.approx(float(je), rel=1e-5)
    _close(tv, jv, 2e-5, "virial")


def test_bonded_eval_weights(c36):
    """Per-family weights, every fourth term off (and pointing at one row,
    so its geometry degenerates) and every fourth at 0.5, in f64: equal
    to JAX's at 1e-9 of the scale and finite (the sanitized geometry
    keeps atan2(0, 0) and 1/0 out of the autograd)."""
    _, tsd = c36
    tt = _tables(tsd, tb, torch.float64)
    weights = {}
    for k in FAMILY_KEYS:
        w = np.ones(len(tt[k]))
        w[::4] = 0.0
        w[1::4] = 0.5
        weights[k] = w
    (jf, je, jv, jpe), (tf, te, tv, tpe) = _both_evals(c36, weights=weights)
    assert np.isfinite(tf).all() and np.isfinite(tpe).all()
    _close(tf, jf, 1e-9, "f")
    _close(te, je, 1e-9, "e")
    _close(tv, jv, 1e-9, "virial")
    _close(tpe, jpe, 1e-9, "pe")


@pytest.mark.parametrize("min_instances", [1, 2])
def test_batched_plus_leftover_equals_generic(c36, min_instances):
    """build_batched_bonded batches the intra-residue terms and leaves the
    junction terms and CMAP to the generic evaluator (with min_instances
    = 2, as Simulation asks, also every term of the three peptide
    residues, types of one instance); the two together equal bonded_eval
    on the whole table (f64, 1e-9 of the scale), as the JAX package's
    test_batched_eval_junction_total."""
    _, sd = c36
    tt = _tables(sd, tb, torch.float64)
    n_pad = sd.state.n_pad
    plan, left = tbb.build_batched_bonded(tt, sd.residue_instances, n_pad,
                                          torch.float64,
                                          min_instances=min_instances)
    assert plan is not None and tbb.has_terms(left)
    assert "cmap_atoms" in left and "torsions" in left
    names = {tp["name"] for tp in plan["types"]}
    if min_instances == 1:
        assert len(left["torsions"]) < len(tt["torsions"])
        assert {"ALA__nter", "GLY", "ALA__cter", "TIP3"} <= names
    else:
        assert len(left["torsions"]) == len(tt["torsions"])
        assert names == {"TIP3"}
    r = _positions(sd, torch.float64)
    L = sd.box.lengths
    gen = tb.bonded_eval(r, L, tt, n_pad, torch.float64)
    bat = tbb.batched_bonded_eval(r, L, plan, n_pad, torch.float64)
    rest = tb.bonded_eval(r, L, left, n_pad, torch.float64)
    for g, b, x, what in zip(gen, bat, rest, ("f", "e", "virial", "pe")):
        _close((b + x).numpy(), g.numpy(), 1e-9, what)


def test_resolved_batched_torsions_match_jax(tmp_path):
    """The mesh's path on a rank's pool of the ethane fluid (27 molecules,
    half the rows local, the rest ghosts or absent): the batched bonds,
    angles, torsions, bonded LJ pairs and exclusions under the resolver's
    ownership weights equal JAX's resolved evaluation in f64 at 1e-9 of
    the scale, finite, with every row of a disowned instance exactly 0
    (disowned instances gather arbitrary rows; the torsions' autograd
    runs on their sanitized geometry)."""
    from ddcmd_tpu.parallel import bonded_shard as jbs
    from ddcmd_tpu.potentials import bonded_batch as jbb
    from ddcmd_tpu_torch.parallel import bonded_shard as tbs

    make_fixture(tmp_path, n_mol=27, L=3.0)
    jsd, tsd = _systems(str(tmp_path))
    n = tsd.state.n_local
    gid = np.asarray(tsd.collection.gid, np.int64)
    rng = np.random.default_rng(13)
    pool_rows = rng.permutation(n)[: n - 20]          # 20 atoms absent
    n_l = len(pool_rows) // 2
    pool_gid = gid[pool_rows]
    pool_mask = np.ones(len(pool_rows), bool)
    r = _positions(tsd, torch.float64).numpy()[pool_rows]
    L = tsd.box.lengths.numpy()
    jplan, _ = jbb.build_batched_bonded(
        _tables(jsd, jb, jnp.float64), jsd.residue_instances,
        tsd.state.n_pad, jnp.float64, gid=gid)
    tplan, tleft = tbb.build_batched_bonded(
        _tables(tsd, tb, torch.float64), tsd.residue_instances,
        tsd.state.n_pad, torch.float64, gid=gid)
    assert not tbb.has_terms(tleft)
    assert {"torsions", "bpairs"} <= set(tplan["types"][0]["fams"])
    jres = jbs.resolve_batched(jplan, jnp.asarray(pool_gid),
                               jnp.asarray(pool_mask), n_l)
    tres = tbs.resolve_batched(tplan, torch.as_tensor(pool_gid),
                               torch.as_tensor(pool_mask), n_l)
    n_pool = len(pool_rows)
    jout = jax.jit(lambda r, L: jbb.batched_bonded_eval(
        r, L, jplan, n_pool, jnp.float64, resolved=jres))(
        jnp.asarray(r), jnp.asarray(L))
    tout = tbb.batched_bonded_eval(torch.as_tensor(r), torch.as_tensor(L),
                                   tplan, n_pool, torch.float64,
                                   resolved=[(rows, w.double())
                                             for rows, w in tres])
    for j, t, what in zip(jout, tout, ("f", "e", "virial", "pe")):
        assert torch.isfinite(t).all(), what
        _close(t.numpy(), np.asarray(j), 1e-9, what)
    rows, w = tres[0]
    assert 0 < float(w.sum()) < len(w)
    owned = rows.reshape(len(w), -1)[w > 0].reshape(-1)
    free = torch.ones(n_pool, dtype=torch.bool)
    free[owned] = False
    assert free.any() and not tout[0][free].any() and not tout[3][free].any()
