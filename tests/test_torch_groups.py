"""Slice 14, the GROUP types (core/groups.py) against the JAX package in
f64: group_from_deck's parameters for every type, GroupTable.coefficients
(teq_override too), velocity_update front and back for every kind and
hook fed JAX's own draws (jax.random.normal on the kick's key, and
fold_in(key, 7919 + 31 gidx + j) for UNIONGROUP member j), the
DOUBLE_MIRROR planes in time, the EXTFORCE term, 20-step Simulation runs
of two noiseless multi-group decks and the GLOBAL_ENERGY law after two
refreshes.

Tolerances: parameters and coefficients exact; kicks 1e-12 absolute
(velocities of order 1 nm/ps); first energies rel 1e-10, forces 1e-10 of
the force scale; 20-step runs 1e-10 of the positions' and velocities'
scales (positions modulo the box); the GLOBAL_ENERGY targets rel 1e-9.
"""

import math
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.core import groups as jg
from ddcmd_tpu.core.box import Box as JBox
from ddcmd_tpu.integrators.nglf import _hooks_at as j_hooks_at
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.objects import ObjectDB as JObjectDB
from ddcmd_tpu.objects.eq import EqTarget as JEqTarget
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.core import groups as tg
from ddcmd_tpu_torch.core.box import Box as TBox
from ddcmd_tpu_torch.integrators.nglf import device_hooks as t_device_hooks
from ddcmd_tpu_torch.integrators.nglf import hooks_at as t_hooks_at
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.objects import ObjectDB as TObjectDB
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.objects.eq import EqTarget as TEqTarget
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)

# one of every type group_from_deck knows, with non-default parameters
DECK = """
lang GROUP { type=LANGEVIN; Teq=RAMP(300,340,0,10ps); tau=0.8ps; }
ge GROUP { type=LANGEVIN; Teq=250K; tau=0.5ps; Teq_dynamics=GLOBAL_ENERGY;
  Cp=0.05 kJ*mol^-1*K^-1; }
free GROUP { type=FREE; }
none GROUP { type=NONE; }
frozen GROUP { type=FROZEN; }
fixv GROUP { type=FIXEDVELOCITY; velocity=1e-3 -2e-3 5e-4 Angstrom/fs; }
ext GROUP { type=EXTFORCE; force=0.01 -0.02 0.03 eV/Angstrom; }
quench GROUP { type=QUENCH; }
ber GROUP { type=BERENDSEN; Teq=RAMP(200,260,0,1ps); tau=0.2ps; }
piston GROUP { type=PISTON; vz=RAMP(0,2e-3,0,40fs); }
shear GROUP { type=SHEAR; tau=0.1ps; top_width=6 Angstrom;
  bottom_width=7 Angstrom; top_velocity=2e-3 Angstrom/fs;
  bottom_velocity=-1e-3 Angstrom/fs; top_temp=150 K; bottom_temp=90 K;
  top_center=7 Angstrom; bottom_center=-8 Angstrom; }
shwall GROUP { type=SHWALL; tau=0.3ps; top_width=5 Angstrom;
  bottom_width=4 Angstrom; top_velocity=1e-3 Angstrom/fs;
  bottom_velocity=-3e-3 Angstrom/fs; top_temp=120 K; bottom_temp=200 K; }
mirror GROUP { type=DOUBLE_MIRROR; point1=0 0 -9 Angstrom;
  point2=0 0 9 Angstrom; normal1=0 0.2 1; normal2=0 0 -1;
  v1=1e-3 Angstrom/fs; v2=-2e-3 Angstrom/fs; outputRate=5; }
union GROUP { type=UNIONGROUP; groups=lang ext piston; }
ion GROUP { type=IONIZATION; }
odd GROUP { type=SOMETHING; }
"""
NAMES = ["lang", "ge", "free", "none", "frozen", "fixv", "ext", "quench",
         "ber", "piston", "shear", "shwall", "mirror", "union", "ion", "odd"]
TIMES = (0.0, 0.013, 0.37, 2.5)


def _dbs():
    jdb, tdb = JObjectDB(), TObjectDB()
    jdb.compile_string(DECK)
    tdb.compile_string(DECK)
    return jdb, tdb


def _groups(names=NAMES):
    """Both packages' Group objects of `names`; the unknown type warns in
    both."""
    jdb, tdb = _dbs()
    out = []
    for mod, db in ((jg, jdb), (tg, tdb)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out.append([mod.group_from_deck(db, nm, i)
                        for i, nm in enumerate(names)])
        assert any("SOMETHING" in str(x.message) for x in w) == \
            ("odd" in names)
    return out


def _same_value(a, b, what):
    if isinstance(a, JEqTarget):
        assert isinstance(b, TEqTarget), what
        for t in TIMES:
            assert b(t) == a(t), (what, t)
            assert b.integral(0.0, t) == a.integral(0.0, t), (what, t)
    elif isinstance(a, jg.Group):
        _same_group(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _same_value(x, y, what)
    elif callable(a):
        for t in TIMES:
            assert b(t) == a(t), (what, t)
    else:
        assert b == a, what


def _same_group(j, t):
    assert (t.name, t.index, t.type, t.tau) == (j.name, j.index, j.type,
                                                j.tau)
    assert tuple(t.vcm) == tuple(j.vcm)
    assert tuple(t.extforce) == tuple(j.extforce)
    assert (t.Teq is None) == (j.Teq is None)
    if j.Teq is not None:
        _same_value(j.Teq, t.Teq, f"{j.name} Teq")
    assert sorted(t.parms) == sorted(j.parms), j.name
    for k in j.parms:
        _same_value(j.parms[k], t.parms[k], f"{j.name}.{k}")


@pytest.mark.parametrize("name", NAMES)
def test_group_from_deck_matches_jax(name):
    """Every type's parameters: units, eq targets, normalised mirror
    normals, UNIONGROUP members, IONIZATION / unknown types as FREE (the
    unknown one with the JAX package's warning)."""
    jgs, tgs = _groups([name])
    _same_group(jgs[0], tgs[0])


def test_group_table_matches_jax():
    """GroupTable.build (UNIONGROUP members as hidden trailing groups),
    KIND, shear_groups and coefficients with and without teq_override,
    exactly, at several times."""
    jgs, tgs = _groups()
    jt, tt = jg.GroupTable.build(jgs), tg.GroupTable.build(tgs)
    assert [g.name for g in tt.groups] == [g.name for g in jt.groups]
    assert tg.GroupTable.KIND == jg.GroupTable.KIND
    np.testing.assert_array_equal(tt.kind, jt.kind)
    np.testing.assert_array_equal([g.tau for g in tt.groups], jt.tau)
    np.testing.assert_array_equal(tt.vcm, jt.vcm)
    jh, th = jt.shear_groups, tt.shear_groups
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_value(a[k], b[k], k)
    assert tt.union_draws == tuple(
        (p["gidx"], j) for p in jh if p.get("style") == "union"
        for j in range(len(p["members"])))
    assert tt.has_berendsen and tt.time_dependent
    ge = NAMES.index("ge")
    for t in TIMES:
        for over in (None, {ge: 412.5}):
            jc = jt.coefficients(t, 0.002, dtype=jnp.float64,
                                 teq_override=over)
            tc = tt.coefficients(t, 0.002, dtype=torch.float64,
                                 teq_override=over)
            assert len(tc) == len(jc) == 6
            for a, b in zip(jc, tc):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# velocity_update, fed JAX's draws
# ---------------------------------------------------------------------------

N_PAD, N, L_BOX = 256, 220, 2.4     # nm
KICK_CASES = {
    # case: (groups beside FREE, has_berendsen)
    "LANGEVIN": (["lang"], False),
    "GLOBAL_ENERGY": (["ge"], False),
    "FROZEN": (["frozen"], False),
    "FIXEDVELOCITY": (["fixv"], False),
    "EXTFORCE": (["ext"], False),
    "QUENCH": (["quench"], False),
    "BERENDSEN": (["ber", "lang"], True),
    "PISTON": (["piston"], False),
    "SHEAR": (["shear"], False),
    "SHWALL": (["shwall"], False),
    "DOUBLE_MIRROR": (["mirror"], False),
    "UNIONGROUP": (["union"], False),
    "IONIZATION_NONE": (["ion", "none"], False),
}


def _kick_inputs(n_groups, seed=5):
    rng = np.random.default_rng(seed)
    r = (rng.random((N_PAD, 3)) - 0.5) * L_BOX
    v = rng.standard_normal((N_PAD, 3))
    f = rng.standard_normal((N_PAD, 3)) * 300.0
    mass = rng.uniform(20.0, 90.0, N_PAD)
    gid = rng.integers(0, n_groups, N_PAD)
    mask = np.arange(N_PAD) < N
    return r, v, f, mass, gid, mask


@pytest.mark.parametrize("mode", ["front", "back"])
@pytest.mark.parametrize("case", list(KICK_CASES))
def test_kick_matches_jax(case, mode):
    """One half-kick of FREE beside the case's groups (their hooks with
    the mirror planes advanced to t = 0.3 ps) equals the JAX package's,
    given its standard-normal draws; padding rows are zero."""
    names, berendsen = KICK_CASES[case]
    names = ["free"] + names
    jgs, tgs = _groups(names)
    jt, tt = jg.GroupTable.build(jgs), tg.GroupTable.build(tgs)
    half, time = 0.002, 0.3
    jc = jt.coefficients(time, half, dtype=jnp.float64,
                         teq_override={i: 275.0 for i, n in enumerate(names)
                                       if n == "ge"})
    tc = tt.coefficients(time, half, dtype=torch.float64,
                         teq_override={i: 275.0 for i, n in enumerate(names)
                                       if n == "ge"})
    r, v, f, mass, gid, mask = _kick_inputs(len(names))
    key = jax.random.PRNGKey(17)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 0))
    k = k1 if mode == "front" else k2
    shape = (N_PAD, 3)
    g = np.asarray(jax.random.normal(k, shape, dtype=jnp.float64))
    draws = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(k, 7919 + 31 * gi + j), shape,
        dtype=jnp.float64))) for gi, j in tt.union_draws]
    jctx = tctx = None
    if jt.shear_groups:
        jbox = JBox.from_h(np.diag([L_BOX] * 3), dtype=jnp.float64)
        tbox = TBox.from_h(np.diag([L_BOX] * 3), dtype=torch.float64)
        jctx = (jnp.asarray(r), jbox.lengths,
                j_hooks_at(time, jbox, jt.shear_groups))
        tctx = (torch.tensor(r), tbox.lengths,
                t_hooks_at(time, tbox, t_device_hooks(
                    tt.shear_groups, torch.float64, "cpu")), draws)
    jv = jg.velocity_update(mode, jnp.asarray(v), jnp.asarray(f),
                            jnp.asarray(mass), jnp.asarray(gid, jnp.int32),
                            jc, half, k, jnp.asarray(mask),
                            has_berendsen=berendsen, shear_ctx=jctx)
    tv = tg.velocity_update(mode, torch.tensor(v), torch.tensor(f),
                            torch.tensor(mass), torch.tensor(gid), tc, half,
                            torch.tensor(g), torch.tensor(mask),
                            has_berendsen=berendsen, shear_ctx=tctx)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-12)
    assert np.all(tv.numpy()[N:] == 0.0)
    if case in ("FROZEN", "FIXEDVELOCITY", "QUENCH", "BERENDSEN",
                "SHEAR", "DOUBLE_MIRROR", "UNIONGROUP") and mode == "front":
        # the case's group did something a FREE kick does not
        free = tg.velocity_update(
            mode, torch.tensor(v), torch.tensor(f), torch.tensor(mass),
            torch.zeros(N_PAD, dtype=torch.int64), tc, half,
            torch.tensor(g), torch.tensor(mask))
        assert not torch.allclose(tv, free)


def test_mirror_planes_in_time():
    """hooks_at moves each DOUBLE_MIRROR point along its normal at its
    speed and wraps it into the box, as the JAX package's _hooks_at."""
    jgs, tgs = _groups(["mirror", "shear"])
    jt, tt = jg.GroupTable.build(jgs), tg.GroupTable.build(tgs)
    jbox = JBox.from_h(np.diag([2.0, 2.2, 1.9]), dtype=jnp.float64)
    tbox = TBox.from_h(np.diag([2.0, 2.2, 1.9]), dtype=torch.float64)
    for t in (0.0, 0.4, 3.0, 17.0):
        jh, th = j_hooks_at(t, jbox, jt.shear_groups), \
            t_hooks_at(t, tbox, t_device_hooks(tt.shear_groups,
                                              torch.float64, "cpu"))
        for a, b in zip(jh, th):
            assert a["style"] == b["style"] if "style" in a else True
            for k in ("point1", "point2"):
                if k in a:
                    np.testing.assert_allclose(
                        b[k].numpy(), np.asarray(a[k]), rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# decks through Simulation
# ---------------------------------------------------------------------------

def _slabs(names):
    """assign(r, L): atoms in len(names) z slabs."""
    def assign(r, L):
        k = np.clip(((r[:, 2] / L + 0.5) * len(names)).astype(int), 0,
                    len(names) - 1)
        return [names[i] for i in k]
    return assign


AFFINE = {"mob": "type=FREE;", "wall": "type=FROZEN;",
          "fix": "type=FIXEDVELOCITY; velocity=0 2e-3 0 Angstrom/fs;",
          "push": "type=EXTFORCE; force=0 0 0.02 eV/Angstrom;",
          "pist": "type=PISTON; vz=RAMP(0,2e-3,0,20fs);",
          "q": "type=QUENCH;",
          "ber": "type=BERENDSEN; Teq=240K; tau=0.05ps;"}


def _hooks(L):
    return {"sh": chip_smoke.shear_groups(L)["sh"],
            "mir": (f"type=DOUBLE_MIRROR; point1=0 0 {-L / 2 + 3:.6f} "
                    f"Angstrom; point2=0 0 {L / 2 - 3:.6f} Angstrom; "
                    "v1=2e-3 Angstrom/fs; v2=-2e-3 Angstrom/fs;"),
            "un": "type=UNIONGROUP; groups=mem push2;",
            "ion": "type=IONIZATION;"}


_UNION_MEMBERS = ("mem GROUP { type=FREE; }\n"
                  "push2 GROUP { type=EXTFORCE; force=0.02 0 0 "
                  "eV/Angstrom; }\n")


def _group_deck(d, kind):
    chip_smoke.lj_deck(str(d), 500, printrate=10)
    L = chip_smoke.box_edge(str(d))
    if kind == "affine":
        chip_smoke.regroup(str(d), AFFINE, lambda r: _slabs(list(AFFINE))(
            r, L))
    else:
        g = _hooks(L)
        chip_smoke.regroup(str(d), g, lambda r: _slabs(list(g))(r, L),
                           _UNION_MEMBERS)
    return str(d)


def _wrapped_diff(a, b, L):
    d = a - b
    return d - L * np.round(d / L)


@pytest.mark.parametrize("kind", ["affine", "hooks"])
def test_group_decks_run_as_jax(tmp_path, monkeypatch, kind):
    """20 f64 steps of a deck whose z slabs hold the affine kinds (FREE,
    FROZEN, FIXEDVELOCITY, EXTFORCE, a PISTON ramp, QUENCH, BERENDSEN)
    or the hooks (SHEAR, DOUBLE_MIRROR, a UNIONGROUP of FREE and
    EXTFORCE, IONIZATION), none of them drawing noise: the port's
    Simulation and the JAX package's (at its fixed rebuild cadence, the
    port's) give the same positions, velocities and energies."""
    monkeypatch.setenv("DDCMD_FIXED_REBUILD", "1")
    d = _group_deck(tmp_path, kind)
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    assert ts.engine == "cellblock" == js.engine
    js.run(20, print_fn=lambda s: None)
    ts.run(20, print_fn=lambda s: None)
    n = ts.sysdef.state.n_local
    L = ts.ss.box.lengths.numpy()
    rj, vj = np.asarray(js.ss.state.r)[:n], np.asarray(js.ss.state.v)[:n]
    rt, vt = ts.ss.state.r.numpy()[:n], ts.ss.state.v.numpy()[:n]
    assert np.abs(_wrapped_diff(rt, rj, L)).max() <= 1e-10 * L.max()
    assert np.abs(vt - vj).max() <= 1e-10 * np.abs(vj).max()
    assert float(ts.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-10)
    g = ts.ss.state.group.numpy()[:n]
    names = [x.name for x in ts.sysdef.groups]
    if kind == "affine":
        assert np.all(vt[g == names.index("wall")] == 0.0)
        fix = vt[g == names.index("fix")]
        np.testing.assert_allclose(fix, np.broadcast_to(
            [0.0, 0.2, 0.0], fix.shape), atol=1e-12)
    # something moved
    assert np.abs(vt).max() > 1e-3


def test_extforce_term_matches_jax(tmp_path):
    """The EXTFORCE term: the first energy and forces of the affine deck
    equal the JAX package's, and the term adds F to each member's force
    and -F.r to its energy."""
    d = _group_deck(tmp_path, "affine")
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    js.first_energy()
    ts.first_energy()
    n = ts.sysdef.state.n_local
    fj = np.asarray(js.ss.state.f)[:n]
    ft = ts.ss.state.f.numpy()[:n]
    assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
    assert float(ts.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-10)
    ext = ts.force_fn.terms[-1]
    fi, e, vir, pe = ext(ts.ss.state, ts.ss.box, None)
    g = ts.ss.state.group.numpy()
    push = [x.name for x in ts.sysdef.groups].index("push")
    F = 0.02 * U.unit_scale("eV") / U.unit_scale("Angstrom")
    sel = g[:n] == push
    np.testing.assert_allclose(fi.numpy()[:n][sel][:, 2], F, rtol=1e-12)
    assert np.all(fi.numpy()[:n][~sel] == 0.0)
    r = ts.ss.state.r.numpy()[:n]
    assert float(e) == pytest.approx(-F * r[sel][:, 2].sum(), rel=1e-12)
    assert not vir.any()


def test_global_energy_law(tmp_path):
    """Teq_dynamics=GLOBAL_ENERGY (langevin.c:31-51, as
    tests/test_boxtime.py:144-183): the first refresh pins the total at
    the first energy and keeps Teq, the second sets Teq = (total -
    E)/(Cp N) with E the last step's energy, read from the dispatch's
    rows."""
    d = str(tmp_path)
    chip_smoke.lj_deck(d, 500, printrate=10)
    cp = 0.05
    p = os.path.join(d, "object.data")
    text = open(p).read()
    text = text.replace(
        "free GROUP { type=LANGEVIN; Teq=120.0K; tau=0.5ps; }",
        "free GROUP { type=LANGEVIN; Teq=120.0K; tau=0.5ps; "
        f"Teq_dynamics=GLOBAL_ENERGY; Cp={cp} kJ*mol^-1*K^-1; }}")
    assert "GLOBAL_ENERGY" in text
    open(p, "w").write(text)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    g = sim.sysdef.group_table.groups[0]
    assert g.parms["Cp"] == pytest.approx(cp)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    e0 = float(sim.ss.energy.eion)

    def applied_teq():
        return float(sim.coeffs[2][0]) * g.tau / (2.0 * U.kB)

    sim.run(10, print_fn=lambda s: None)
    total = 120.0 * cp * n + e0
    assert sim._ge_total[0] == pytest.approx(total, rel=1e-12)
    assert applied_teq() == pytest.approx(120.0, rel=1e-9)
    e1 = float(sim.ss.energy.eion)
    sim.run(10, print_fn=lambda s: None)
    expect = (total - e1) / (cp * n)
    assert not math.isclose(expect, 120.0, abs_tol=1e-6)
    assert applied_teq() == pytest.approx(expect, rel=1e-9)
