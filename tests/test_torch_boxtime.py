"""Slice 14, the prescribed box(t) (boxPrescriptiveTime.c) against the JAX
package in f64: _parse_box_time for each mode (dudt of 1, 2, 3 and 9
components and eq schedules, Veq, deformationRate, rotationMatrix) and
_box_time_tilts; build_system's box (ROTATION folded into h, a tilting
deformation demoted to the triclinic paths); Simulation._box_lam against
the JAX package's per-step factors; 20-step runs of each mode at the
JAX package's fixed rebuild cadence (the port's), with STRAIN and VOLUME
also against their closed forms; a STRAIN beside the Berendsen barostat,
the box(t) factor on the box the barostat left.

Tolerances: parsed values exact; h at build exact; the box factors 1e-13
relative (the port accumulates the JAX package's per-step factor over a
dispatch in f64); 20-step runs 1e-10 of each quantity's scale (r modulo
the box); closed forms rel 1e-9 (tests/test_boxtime.py's).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.core import system as jsys
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.objects import DeckError as JDeckError
from ddcmd_tpu.objects import ObjectDB as JObjectDB
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.core import system as tsys
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.objects import DeckError as TDeckError
from ddcmd_tpu_torch.objects import ObjectDB as TObjectDB
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)

C, S = math.cos(0.1), math.sin(0.1)
BOXES = {
    "none": "",
    "dudt1": "dudt=1e-5;",
    "dudt2": "dudt=1e-5 -2e-5;",
    "dudt3": "dudt=0 0 1e-5;",
    "dudt9": "dudt=1e-5 0 0 0 2e-5 0 0 0 -1e-5;",
    "dudt_ramp": "dudt=RAMP(0,2e-5,0,40fs) 0 1e-5;",
    "volume": "Veq=46 Angstrom^3;",
    "volume_ramp": "Veq=RAMP(48,44,0,60fs);",
    "deformation_diag": "deformationRate=1e-5 0 0 0 -1e-5 0 0 0 2e-5;",
    "deformation": "deformationRate=5e-6 2e-5 0 0 0 0 0 0 0;",
    "rotation": f"rotationMatrix={C} {-S} 0 {S} {C} 0 0 0 1;",
}
TIMES = (0.0, 0.02, 0.05, 0.3)


def _boxobj(db_cls, extra):
    db = db_cls()
    db.compile_string(f"box BOX {{ type=ORTHORHOMBIC; pbc=7; "
                      f"h= 20 0 0 0 20 0 0 0 20 ; {extra} }}")
    return db.get("box", "BOX")


def _same(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert sorted(a) == sorted(b)
    assert a["mode"] == b["mode"]
    for k in a:
        if k == "eqs":
            for ra, rb in zip(a[k], b[k]):
                for ea, eb in zip(ra, rb):
                    for t in TIMES:
                        assert eb(t) == ea(t)
                        assert eb.integral(0.0, t) == ea.integral(0.0, t)
        elif k == "eq":
            for t in TIMES:
                assert b[k](t) == a[k](t)
        elif k in ("D", "R"):
            np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("name", list(BOXES))
def test_parse_box_time_matches_jax(name):
    """Each mode parses to the JAX package's dict (eq targets compared by
    value and integral), and tilts where JAX's does."""
    a = jsys._parse_box_time(_boxobj(JObjectDB, BOXES[name]))
    b = tsys._parse_box_time(_boxobj(TObjectDB, BOXES[name]))
    _same(a, b)
    if a is not None:
        assert tsys._box_time_tilts(b) == jsys._box_time_tilts(a)
    assert (name == "deformation") == (
        b is not None and tsys._box_time_tilts(b))


def test_parse_box_time_refuses_four_components():
    with pytest.raises(JDeckError):
        jsys._parse_box_time(_boxobj(JObjectDB, "dudt=1 2 3 4;"))
    with pytest.raises(TDeckError, match="1/2/3/9"):
        tsys._parse_box_time(_boxobj(TObjectDB, "dudt=1 2 3 4;"))


def _deck(d, name, steps_deck=True):
    chip_smoke.lj_deck(str(d), 500, printrate=10, free=True,
                       edit=chip_smoke.box_edit(BOXES[name]))
    return str(d)


@pytest.mark.parametrize("name", ["dudt3", "deformation", "rotation",
                                  "volume"])
def test_build_system_box_matches_jax(tmp_path, name):
    """build_system's box: h, the ortho flag (a tilting deformation and a
    rotated box go triclinic), box_time (ROTATION folded, not kept)."""
    d = _deck(tmp_path, name)
    jsd = jsys.build_system(j_load(d)[0], d, dtype=jnp.float64)
    tsd = tsys.build_system(t_load(d)[0], d, dtype=torch.float64)
    np.testing.assert_array_equal(tsd.box.h.numpy(), np.asarray(jsd.box.h))
    assert tsd.box.ortho == jsd.box.ortho == (name == "dudt3"
                                              or name == "volume")
    _same(jsd.box_time, tsd.box_time)
    assert (tsd.box_time is None) == (name == "rotation")


@pytest.mark.parametrize("name", ["dudt9", "dudt_ramp", "volume_ramp",
                                  "deformation"])
def test_box_lam_matches_jax(tmp_path, name):
    """The port's (E[i], M[i]) for step i of a k-step dispatch are the
    JAX package's per-step (E, M) taken i + 1 times, at two dispatch
    starts."""
    d = _deck(tmp_path, name)
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    for t in (0.0, 0.036):
        js.ss = js.ss.replace(time=jnp.asarray(t))
        ts.ss = ts.ss.replace(time=t)
        k = 7
        Ej, Mj = (np.asarray(x) for x in js._box_lam(k))
        Et, Mt = (x.numpy() for x in ts._box_lam(k))
        assert Et.shape == Mt.shape == (k, 3, 3)
        for i in range(k):
            np.testing.assert_allclose(Et[i], Ej ** (i + 1), rtol=1e-13,
                                       atol=0)
            np.testing.assert_allclose(
                Mt[i], np.linalg.matrix_power(Mj, i + 1), rtol=1e-13,
                atol=1e-300)
        assert not (np.allclose(Ej, 1.0) and np.allclose(Mj, np.eye(3)))


@pytest.mark.parametrize("name", ["dudt9", "dudt_ramp", "volume",
                                  "deformation", "rotation"])
def test_box_time_runs_match_jax(tmp_path, monkeypatch, name):
    """20 FREE steps with the box prescribed: the port's Simulation
    against the JAX package's (fixed rebuild cadence), then STRAIN's and
    VOLUME's closed forms (tests/test_boxtime.py): L = L0 exp(int u dt)
    on each axis, V = n Veq at the dispatch's end."""
    monkeypatch.setenv("DDCMD_FIXED_REBUILD", "1")
    d = _deck(tmp_path, name)
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    assert ts.engine == js.engine
    h0 = ts.ss.box.h.numpy().copy()
    js.run(20, print_fn=lambda s: None)
    ts.run(20, print_fn=lambda s: None)
    n = ts.sysdef.state.n_local
    h = np.asarray(js.ss.box.h)
    ht = ts.ss.box.h.numpy()
    np.testing.assert_allclose(ht, h, rtol=0, atol=1e-10 * np.abs(h).max())
    s = (ts.ss.state.r.numpy()[:n] - np.asarray(js.ss.state.r)[:n]) \
        @ np.linalg.inv(h).T
    assert np.abs((s - np.round(s)) @ h.T).max() <= 1e-10 * np.abs(h).max()
    vj = np.asarray(js.ss.state.v)
    assert np.abs(ts.ss.state.v.numpy() - vj).max() <= 1e-10 * \
        np.abs(vj).max()
    t_end = 20 * ts.sysdef.cfg.dt
    if name == "dudt9":
        u = np.array([1e-5, 2e-5, -1e-5]) * 1e3      # 1/fs -> 1/ps
        np.testing.assert_allclose(np.diagonal(ht), np.diagonal(h0)
                                   * np.exp(u * t_end), rtol=1e-9)
    elif name == "volume":
        assert abs(np.linalg.det(ht)) == pytest.approx(n * 46e-3, rel=1e-9)
    elif name == "rotation":
        np.testing.assert_array_equal(ht, h0)
    else:
        assert not np.allclose(ht, h0, rtol=1e-6)


BAROSTAT = ("type=NGLFCONSTRAINT; P0=500 bar; beta=1e-4/bar; "
            "tauBarostat=0.1 ps;")


def test_box_time_under_barostat_matches_jax(tmp_path, monkeypatch):
    """A box(t) beside the Berendsen barostat (NGLFCONSTRAINT, beta > 0):
    both move the box every step, the box(t) factor applied to the box
    the barostat left (nglf.py:158 of the JAX package).  20 FREE steps
    of a 9-component STRAIN against the JAX package's at 1e-10 of each
    quantity's scale, and the box away from where the box(t) alone puts
    it (the one-step M of a deformation takes the same path, and
    test_box_lam_matches_jax holds it to the JAX package's)."""
    monkeypatch.setenv("DDCMD_FIXED_REBUILD", "1")
    d = str(tmp_path)
    chip_smoke.lj_deck(d, 500, printrate=10, free=True,
                       edit=chip_smoke.chain(
                           chip_smoke.box_edit(BOXES["dudt9"]),
                           lambda t: t.replace("type=NGLF;", BAROSTAT, 1)))
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    assert ts.barostat is not None and ts.sysdef.box_time is not None
    h0 = ts.ss.box.h.numpy().copy()
    Es, Ms = (x.numpy() for x in ts._box_lam(20))
    js.run(20, print_fn=lambda s: None)
    ts.run(20, print_fn=lambda s: None)
    n = ts.sysdef.state.n_local
    h = np.asarray(js.ss.box.h)
    ht = ts.ss.box.h.numpy()
    np.testing.assert_allclose(ht, h, rtol=0, atol=1e-10 * np.abs(h).max())
    s = (ts.ss.state.r.numpy()[:n] - np.asarray(js.ss.state.r)[:n]) \
        @ np.linalg.inv(h).T
    assert np.abs((s - np.round(s)) @ h.T).max() <= 1e-10 * np.abs(h).max()
    vj = np.asarray(js.ss.state.v)
    assert np.abs(ts.ss.state.v.numpy() - vj).max() <= 1e-10 * \
        np.abs(vj).max()
    # the barostat's moves survive: not the box(t)'s box alone
    alone = (Es[-1] * h0) @ Ms[-1]
    assert np.abs(ht - alone).max() > 1e-4 * np.abs(h0).max()
