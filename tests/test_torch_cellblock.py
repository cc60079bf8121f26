"""The plain cell-block engine of the port (ops/cellpair.py) and the decks
it carries, against the JAX package: the plan, the binning and the
block geometry on orthorhombic and triclinic boxes, cellpair_eval_half
on a charged two-type state (orthorhombic, triclinic, pbc = 3), the
engine choice, the REFLECT slab, the triclinic constraint projection and
NVE run, RESTRAINT and --f64.

Both packages run in float64 here; the engine's physics is the JAX
engine's, so energies, forces and virials agree to rounding.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.core.state import State as JState
from ddcmd_tpu.integrators.constraints import (
    build_constraint_fn as j_build_constraint_fn)
from ddcmd_tpu.models import lj_fluid as j_lj_fluid
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.ops import cellpair as jcb
from ddcmd_tpu.potentials.restraint import restraint_eval as j_restraint
from ddcmd_tpu.run.cli import load_db as j_load_db
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.core.state import State
from ddcmd_tpu_torch.integrators.constraints import build_constraint_fn
from ddcmd_tpu_torch.models import lj_fluid, load
from ddcmd_tpu_torch.ops import cellpair as cb
from ddcmd_tpu_torch.potentials.restraint import restraint_eval
from ddcmd_tpu_torch.run import cli
from ddcmd_tpu_torch.run.cli import load_db
from ddcmd_tpu_torch.run.simulate import Simulation

torch.set_num_threads(2)

RCUT, SKIN = 1.1, 0.2
F64 = torch.float64


def _monoclinic_h(L, tilt):
    """Lattice vectors as columns: a=(L,0,0), b=(tilt*L, L, 0), c=(0,0,L)."""
    h = np.diag([L, L, L]).astype(np.float64)
    h[0, 1] = tilt * L
    return h


def _geom(kind):
    if kind == "ortho":
        return np.array([4.4, 5.2, 4.8])
    return _monoclinic_h(4.6, float(kind[4:]))


def _system(n, geom, seed=3):
    """n particles uniform in the box, charges, two LJ types."""
    h = geom if geom.ndim == 2 else np.diag(geom)
    rng = np.random.default_rng(seed)
    r = (rng.random((n, 3)) - 0.5) @ h.T
    q = rng.standard_normal(n) * 0.2
    tidx = rng.integers(0, 2, n)
    return r, q, tidx


def _tables(T):
    sigma = np.array([[0.47, 0.52], [0.52, 0.43]])[:T, :T]
    eps = np.array([[2.0, 2.4], [2.4, 1.8]])[:T, :T]
    sr6 = (sigma / RCUT) ** 6
    return dict(sigma=sigma, eps=eps, shift=-4 * eps * (sr6 ** 2 - sr6),
                rcut2=RCUT ** 2, krf=0.5 / RCUT ** 3, crf=1.5 / RCUT,
                keR=9.0)


def _edit(d, fn):
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    new = fn(text)
    assert new != text
    with open(p, "w") as f:
        f.write(new)


@pytest.mark.parametrize("kind", ["ortho", "tilt0.1", "tilt0.3"])
def test_plan_binning_geometry_match_jax(kind):
    """CellBlockGrid.plan, half_grid, half_back_map, pbc_allowed,
    build_cell_slots (the permutation equal, not close) and
    block_geometry equal the JAX package's."""
    geom = _geom(kind)
    n = 300
    r, _, _ = _system(n, geom)
    jg = jcb.CellBlockGrid.plan(geom, RCUT, SKIN, n)
    tg = cb.CellBlockGrid.plan(geom, RCUT, SKIN, n)
    assert (tg.ncells, tg.cap, tg.rlist) == (jg.ncells, jg.cap, jg.rlist)
    np.testing.assert_array_equal(tg.stencil_cells, jg.stencil_cells)
    np.testing.assert_array_equal(tg.wrap, jg.wrap)
    assert tg.with_cap(45).cap == jg.with_cap(45).cap == 48
    jh, th = jcb.half_grid(jg), cb.half_grid(tg)
    np.testing.assert_array_equal(th.stencil_cells, jh.stencil_cells)
    np.testing.assert_array_equal(cb.half_back_map(th),
                                  jcb.half_back_map(jh))
    for pbc in (7, 3, 4):
        ja, ta = jcb.pbc_allowed(jh, pbc), cb.pbc_allowed(th, pbc)
        if ja is None:
            assert ta is None
        else:
            np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(cb.perp_spans(geom)[0],
                                  jcb.perp_spans(geom)[0])

    jperm, jov = jcb.build_cell_slots(jnp.asarray(r), jnp.ones(n),
                                      jnp.asarray(geom), jg)
    tperm, tov = cb.build_cell_slots(torch.as_tensor(r),
                                     torch.ones(n, dtype=F64),
                                     torch.as_tensor(geom), tg)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    assert bool(tov) == bool(jov)

    jsh, jc = jcb.block_geometry(jh, jnp.asarray(geom), jnp.float64)
    tsh, tc = cb.block_geometry(th, torch.as_tensor(geom), F64)
    np.testing.assert_allclose(tsh.numpy(), np.asarray(jsh), atol=1e-14)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-14)


@pytest.mark.parametrize("kind,pbc,T", [("ortho", 7, 1), ("ortho", 7, 2),
                                        ("tilt0.3", 7, 2), ("ortho", 3, 2)])
def test_cellpair_eval_half_matches_jax(kind, pbc, T):
    """cellpair_eval_half, LJ + reaction field, T = 1 and T = 2, against
    the JAX engine on a charged state: orthorhombic, triclinic, pbc = 3."""
    geom = _geom(kind)
    n = 300
    r, q, tidx = _system(n, geom, seed=5)
    tidx = tidx % T
    jt = {k: jnp.asarray(v, jnp.float64) for k, v in _tables(T).items()}
    tt = {k: (torch.as_tensor(v, dtype=F64) if np.ndim(v) else float(v))
          for k, v in _tables(T).items()}
    jg = jcb.half_grid(jcb.CellBlockGrid.plan(geom, RCUT, SKIN, n))
    tg = cb.half_grid(cb.CellBlockGrid.plan(geom, RCUT, SKIN, n))
    jperm, _ = jcb.build_cell_slots(jnp.asarray(r), jnp.ones(n),
                                    jnp.asarray(geom), jg)
    tperm, ov = cb.build_cell_slots(torch.as_tensor(r),
                                    torch.ones(n, dtype=F64),
                                    torch.as_tensor(geom), tg)
    assert not bool(ov)
    jf, je, jv, jpe = jcb.cellpair_eval_half(
        jnp.asarray(r), jnp.asarray(q), jnp.asarray(tidx), jperm,
        jnp.asarray(geom), jg, jt, jnp.asarray(jcb.half_back_map(jg)),
        coulomb=True, allowed=jcb.pbc_allowed(jg, pbc))
    tf, te, tv, tpe = cb.cellpair_eval_half(
        torch.as_tensor(r), torch.as_tensor(q), torch.as_tensor(tidx), tperm,
        torch.as_tensor(geom), tg, tt, cb.half_back_map(tg), coulomb=True,
        allowed=cb.pbc_allowed(tg, pbc))
    scale = float(np.abs(jf).max())
    assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 1e-10 * scale
    assert float(te) == pytest.approx(float(je), rel=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9,
                               atol=1e-9 * np.abs(jv).max())
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), rtol=1e-9,
                               atol=1e-9 * np.abs(jpe).max())


def _fluid_decks(tmp_path, n=64, edits=(), **kw):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jd)
    os.makedirs(td)
    j_lj_fluid(jd, n=n, **kw)
    lj_fluid(td, n=n, **kw)
    for fn in edits:
        _edit(jd, fn)
        _edit(td, fn)
    return jd, td


def _tilt(s):
    """The box with b = (tilt L, L, 0): h[0,1] = 0.2 L, BOX GENERAL."""
    import re

    m = re.search(r"h= (\S+) 0 0 0 (\S+) 0 0 0 (\S+) ;", s)
    L = float(m.group(1))
    return s.replace(m.group(0),
                     f"h= {L} {0.2 * L:.6f} 0 0 {L} 0 0 0 {L} ;").replace(
        "type=ORTHORHOMBIC;", "type=GENERAL;")


@pytest.mark.parametrize("case", ["f32", "pbc3", "triclinic", "f64"])
def test_engine_choice_matches_jax(tmp_path, case):
    """Simulation's engine equals the JAX package's choice on a TPU: the
    kernels ("pallas" there) for an f32, orthorhombic, fully periodic
    deck, the cell-block engine for pbc < 7, a triclinic box or f64.  The
    JAX side is asked for "pallas" in f32 (it demotes what the deck
    forces) and left on "auto" in f64."""
    edits = {"pbc3": (lambda s: s.replace("pbc=7", "pbc=3"),),
             "triclinic": (_tilt,)}.get(case, ())
    jd, td = _fluid_decks(tmp_path, edits=edits)
    f64 = case == "f64"
    js = JSimulation(*j_load(jd), run_dir=jd,
                     dtype=jnp.float64 if f64 else jnp.float32,
                     engine="auto" if f64 else "pallas")
    ts = Simulation(*load(td), run_dir=td, device="cpu",
                    dtype=F64 if f64 else torch.float32)
    assert ts.engine == {"pallas": "kernel"}.get(js.engine, js.engine)
    assert ts.engine == ("kernel" if case == "f32" else "cellblock")
    if case != "f32":
        with pytest.raises(ValueError, match="kernel"):
            Simulation(*load(td), run_dir=td, device="cpu",
                       dtype=F64 if f64 else torch.float32, engine="kernel")


def _slab(s):
    """pbc = 3 with REFLECT walls in z and a FREE group
    (tests/test_pbc.py:83-120, NGLF in place of NVEGLF)."""
    return (s.replace("pbc=7", "pbc=3")
            .replace("potential=pot;", "potential=pot walls;")
            .replace("type=LANGEVIN; Teq=80.0K; tau=0.5ps;", "type=FREE;")
            + "\nwalls POTENTIAL { type=REFLECT; }\n")


def test_reflect_slab(tmp_path):
    """The pbc = 3 REFLECT slab: first energy against JAX's, then 150 f64
    steps with every atom inside the walls and the energy held."""
    jd, td = _fluid_decks(tmp_path, n=256, edits=(_slab,), T=80.0,
                          dt_fs=3.0)
    js = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64)
    js.first_energy()
    sim = Simulation(*load(td), run_dir=td, device="cpu", dtype=F64)
    assert sim.engine == "cellblock" and sim.post_drift_fn is not None
    sim.first_energy()
    assert float(sim.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-10)
    e0 = float(sim.ss.energy.eion + sim.ss.energy.rk)
    sim.run(150, print_fn=lambda s: None, max_steps_per_dispatch=30)
    n = sim.sysdef.state.n_local
    r = sim.ss.state.r[:n].numpy()
    half = 0.5 * float(sim.ss.box.lengths[2])
    assert np.isfinite(r).all()
    assert r[:, 2].max() <= half + 1e-9 and r[:, 2].min() >= -half - 1e-9
    e1 = float(sim.ss.energy.eion + sim.ss.energy.rk)
    assert e1 == pytest.approx(e0, rel=5e-4, abs=5.0)


def test_triclinic_constraint_projection():
    """The front projection takes the minimum image through the full h: a
    diatomic across the tilted boundary keeps its bond length, and the
    projected velocities equal the JAX package's
    (tests/test_triclinic.py:201)."""
    h = _monoclinic_h(10.0, 0.3)
    d0 = 0.9
    r0 = np.array([1.0, 4.7, 0.0])
    r = np.stack([r0, r0 + np.array([0.0, d0, 0.0]) - h[:, 1]])
    v = np.array([[0.4, -0.2, 0.1], [-0.3, 0.5, 0.2]])
    args = (np.zeros(2), np.array([10.0, 10.0]), np.zeros(2, np.int32),
            np.zeros(2, np.int32), np.arange(2, dtype=np.uint64))
    cons = (np.array([[0, 1]]), np.array([[[0, 1]]]), np.array([[d0]]))
    dt = 0.05
    js = JState.create(r, v, *args, dtype=jnp.float64)
    jv = j_build_constraint_fn(*cons, js.n_pad, jnp.float64)(
        js, dt, "front", box_lengths=jnp.asarray(h)).v
    ts = State.create(r, v, *args, dtype=F64)
    tv = build_constraint_fn(*cons, ts.n_pad, F64)(
        ts, dt, "front", box_lengths=torch.as_tensor(h)).v
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12,
                               atol=1e-14)
    r_new = r + dt * tv[:2].numpy()
    dr = r_new[0] - r_new[1]
    dr = dr - np.round(np.linalg.inv(h) @ dr) @ h.T
    assert np.linalg.norm(dr) == pytest.approx(d0, rel=1e-9)


def _triclinic_deck(d, m=6, spacing=4.0, tilt=0.2, seed=5, dt_fs=4):
    """An LJ fluid on an m^3 lattice in a monoclinic box with a FREE group
    (tests/test_triclinic.py:142-200, NGLF in place of NVEGLF)."""
    L = m * spacing
    h = _monoclinic_h(L, tilt)
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    # a jitter of 0.48 A whatever m (0.02 of the 216-atom box's edge)
    s = (g + 0.5) / m - 0.5 + (rng.random((m ** 3, 3)) - 0.5) * 0.12 / m
    r = s @ h.T
    n = len(r)
    v = rng.standard_normal((n, 3)) * 0.002
    rows = [f"{i} ATOM Ar free " + " ".join("%.8f" % x for x in r[i])
            + " " + " ".join("%.8f" % x for x in v[i]) for i in range(n)]
    hflat = " ".join("%.6f" % x for x in h.reshape(-1))
    hdr = (f"particle FILEHEADER {{type=MULTILINE; datatype=VARRECORDASCII;"
           f" checksum=NONE;\nloop=0; time=0.0;\nnfiles=1; nrecord={n};"
           f" nfields=10;\n"
           f"field_names=id class type group rx ry rz vx vy vz;\n"
           f"field_types=u s s s f f f f f f;\n"
           f"h= {hflat} ;\n}}\n\n")
    with open(os.path.join(d, "atoms#000000"), "w") as f:
        f.write(hdr + "\n".join(rows) + "\n")
    deck = f"""
simulate SIMULATE {{ type=MD; system=system; integrator=nve; dt={dt_fs};
  maxloop=1000; printrate=50; ddc=ddc; }}
ddc DDC {{ updateRate=10; }}
pot POTENTIAL {{ type=PAIR; cutoff=7.0 Angstrom; eps=0.01 eV;
  sigma=3.4 Angstrom; }}
nve INTEGRATOR {{ type=NGLF; T=100K; }}
system SYSTEM {{ type=NORMAL; potential=pot; neighbor=nbr; groups=free;
  box=box; collection=collection; species=Ar; }}
Ar SPECIES {{ type=ATOM; mass=39.948; charge=0; }}
box BOX {{ type=GENERAL; pbc=7; h= {hflat} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=1.2; }}
free GROUP {{ type=FREE; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""
    path = os.path.join(d, "object.data")
    with open(path, "w") as f:
        f.write(deck)
    return path, n


def test_triclinic_nve(tmp_path):
    """216 atoms in a monoclinic box (tilt 0.2), NGLF with a FREE group,
    f64: first energy equal to JAX's, NVE drift over 200 steps under
    3e-4 * n kJ/mol (the JAX test's bound)."""
    deck, n = _triclinic_deck(str(tmp_path))
    js = JSimulation(j_load_db([deck], None, str(tmp_path)), str(tmp_path),
                     run_dir=str(tmp_path), dtype=jnp.float64)
    js.first_energy()
    sim = Simulation(load_db([deck], None, str(tmp_path)), str(tmp_path),
                     run_dir=str(tmp_path), device="cpu", dtype=F64)
    assert sim.engine == "cellblock" and not sim.sysdef.box.ortho
    sim.first_energy()
    assert float(sim.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-10)
    e0 = float(sim.ss.energy.eion) + float(sim.ss.energy.rk)
    sim.run(200, print_fn=lambda s: None)
    e1 = float(sim.ss.energy.eion) + float(sim.ss.energy.rk)
    assert np.isfinite(e1) and abs(e1 - e0) < 3e-4 * n


def test_cli_f64_triclinic(tmp_path):
    """`simulate --f64` runs a triclinic deck in float64 on the cell-block
    engine."""
    deck, _ = _triclinic_deck(str(tmp_path), m=5)
    sim = cli.run(["simulate", "-o", deck, "-n", "10", "--run-dir",
                   str(tmp_path / "run"), "--device", "cpu", "--f64"])
    assert sim.engine == "cellblock" and sim.ss.loop == 10
    assert sim.ss.state.r.dtype == F64
    assert np.isfinite(float(sim.ss.energy.eion))


@pytest.mark.parametrize("kind", ["ortho", "tilt0.3"])
def test_restraint_eval_matches_jax(kind):
    geom = _geom(kind)
    rng = np.random.default_rng(9)
    r, _, _ = _system(40, geom)
    rows = np.array([1, 5, 7, 30])
    r0 = r[rows] + rng.normal(scale=0.3, size=(4, 3))
    kb = rng.random(4) * 100.0
    am = np.array([[1, 1, 1], [1, 0, 1], [0, 0, 1], [1, 1, 0]], float)
    jout = j_restraint(jnp.asarray(r), jnp.ones(40), jnp.asarray(geom),
                       jnp.asarray(rows), jnp.asarray(r0), jnp.asarray(kb),
                       jnp.asarray(am))
    tout = restraint_eval(torch.as_tensor(r), torch.as_tensor(geom),
                          torch.as_tensor(rows), torch.as_tensor(r0),
                          torch.as_tensor(kb), torch.as_tensor(am))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-12)


_RESTRAINT = """
rs POTENTIAL { type=RESTRAINT; }
rlist RESTRAINTLIST { restraintList=r0 r1; }
r0 RESTRAINTPARMS { gid=3; kb=50 kJ/mol/nm^2; x0=0.1 nm; y0=0.2 nm;
  z0=-0.3 nm; }
r1 RESTRAINTPARMS { gid=10; kb=80 kJ/mol/nm^2; x0=-0.5 nm; y0=0.0 nm;
  z0=0.4 nm; fcz=0; }
"""


def test_restraint_deck_steps(tmp_path):
    """A PAIR deck with RESTRAINT springs builds in Simulation (on the
    kernels), its first energy equals JAX's and it steps."""
    jd, td = _fluid_decks(
        tmp_path, edits=(lambda s: s.replace("potential=pot;",
                                             "potential=pot rs;")
                         + _RESTRAINT,))
    js = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64)
    js.first_energy()
    sim = Simulation(*load(td), run_dir=td, device="cpu")
    assert sim.engine == "kernel"
    assert [p[0] for p in sim.sysdef.potentials] == ["PAIR", "RESTRAINT"]
    sim.first_energy()
    assert float(sim.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-4)
    sim.run(20, print_fn=lambda s: None)
    assert sim.ss.loop == 20 and np.isfinite(float(sim.ss.energy.eion))


def test_bilayer_f64_masks_exclusions(tmp_path):
    """A bilayer in f64 runs on the cell-block engine with the exclusion
    channels masking its bonded pairs in the engine (the bonded block adds
    back their reaction-field part): first energy and forces equal the
    JAX engine's, which computes those pairs and subtracts them; then a
    few NPT steps with RATTLE."""
    from ddcmd_tpu.models import martini_bilayer as j_martini_bilayer
    from ddcmd_tpu_torch.models import martini_bilayer

    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jd)
    os.makedirs(td)
    j_martini_bilayer(jd, nx=4, ny=4, water_nm=1.2)
    martini_bilayer(td, nx=4, ny=4, water_nm=1.2)
    js = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64)
    js.first_energy()
    sim = Simulation(*load(td), run_dir=td, device="cpu", dtype=F64)
    assert sim.engine == "cellblock" and sim.constraint_fn is not None
    sim.first_energy()
    n = sim.sysdef.state.n_local
    jf = np.asarray(js.ss.state.f[:n])
    assert np.abs(sim.ss.state.f[:n].numpy() - jf).max() <= \
        1e-8 * np.abs(jf).max()
    assert float(sim.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-9)
    sim.run(20, print_fn=lambda s: None)
    assert sim.ss.loop == 20 and np.isfinite(float(sim.ss.energy.eion))
