"""PAIR Lennard-Jones decks in the port against the JAX package: the
builder's decks, compile_pair's tables, the PAIR term through the pair
kernels' plain versions (T = 1 and T = 2), one NGLF step of the LJ fluid
in both Simulations, the mesh at (1,1,1) over gloo, and the refusal of a
tabulated PAIR in both drivers.

The JAX side runs its cell-block engine in float64 (the port's f32 pair
term is held to the f64 forces, as in tests/test_torch_slice.py), at the
tolerances of tests/test_pallas_cellpair.py: force within 2e-5 of the
force scale, energy and virial rel 1e-4.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import lj_fluid as j_lj_fluid
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.core.system import build_system as t_build_system
from ddcmd_tpu_torch.models import lj_fluid, load
from ddcmd_tpu_torch.ops.cellpair_half import cellpair_half_plain
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
from ddcmd_tpu_torch.run.simulate import Simulation

torch.set_num_threads(2)

N_SMALL = 500


def _edit(d, fn):
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    new = fn(text)
    assert new != text
    with open(p, "w") as f:
        f.write(new)


def _two_species(d):
    """The fluid with every odd particle a second species, Kr, and the
    three species pairs as PAIRPARMS objects (T = 2)."""
    p = os.path.join(d, "atoms#000000")
    with open(p) as f:
        lines = f.read().split("\n")
    out = []
    for ln in lines:
        m = re.match(r"^(\d+) ATOM Ar ", ln)
        if m and int(m.group(1)) % 2:
            ln = ln.replace(" ATOM Ar ", " ATOM Kr ", 1)
        out.append(ln)
    with open(p, "w") as f:
        f.write("\n".join(out))
    _edit(d, lambda s: s.replace("species=Ar;", "species=Ar Kr;")
          + "Kr SPECIES { type=ATOM; mass=83.8; charge=0; }\n"
          "Ar-Ar PAIRPARMS { eps=0.0104 eV; sigma=3.4 Angstrom; }\n"
          "Ar-Kr PAIRPARMS { eps=0.0123 eV; sigma=3.5 Angstrom; }\n"
          "Kr-Kr PAIRPARMS { eps=0.0141 eV; sigma=3.6 Angstrom; }\n")


def _free(d):
    _edit(d, lambda s: s.replace("type=LANGEVIN; Teq=120.0K; tau=0.5ps;",
                                 "type=FREE;"))


def _pair_decks(tmp_path, n=N_SMALL, edits=(), **kw):
    """The same lj_fluid deck from both packages' builders, edited alike."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jd)
    os.makedirs(td)
    j_lj_fluid(jd, n=n, **kw)
    lj_fluid(td, n=n, **kw)
    for fn in edits:
        fn(jd)
        fn(td)
    return jd, td


@pytest.mark.parametrize("table", [False, True], ids=["lj", "table"])
def test_lj_fluid_decks_identical(tmp_path, table):
    jd, td = _pair_decks(tmp_path, table=table)
    names = ["object.data", "atoms#000000"] + (["table.data"] if table
                                               else [])
    for name in names:
        with open(os.path.join(jd, name)) as a, \
                open(os.path.join(td, name)) as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("case", ["lj", "pairparms", "table"])
def test_compile_pair_matches_jax(tmp_path, case):
    """compile_pair's tables equal JAX's: one eps/sigma on the POTENTIAL,
    per-pair PAIRPARMS with two species, and the TableFunction parse."""
    edits = (_two_species,) if case == "pairparms" else ()
    jd, td = _pair_decks(tmp_path, n=64, edits=edits,
                         table=(case == "table"))
    jp = j_build_system(j_load(jd)[0], jd).potentials[0]
    tp = t_build_system(load(td)[0], td).potentials[0]
    assert tp[0] == jp[0] == "PAIR"
    j, t = jp[2], tp[2]
    assert (t.n_species, t.rcut) == (j.n_species, j.rcut)
    for k in ("sigma", "eps", "shift"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    if case == "table":
        assert set(t.table) == set(j.table)
        for k, v in j.table.items():
            np.testing.assert_array_equal(t.table[k], v)
    else:
        assert t.table is None and j.table is None
    if case == "pairparms":
        assert t.n_species == 2 and t.eps[0, 1] != t.eps[0, 0]


def _term_vs_jax(jd, td):
    """(port f, e, virial) of the PAIR term through the per-cell kernel's
    plain version, and JAX's cell-block f64 force function, on the
    deck's start state."""
    jsim = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64,
                       engine="cellblock")
    jsim.first_energy()
    sim = Simulation(*load(td), run_dir=td, device="cpu")
    assert sim.engine == "kernel"
    sim.first_energy()
    n = sim.sysdef.state.n_local
    e = sim.ss.energy
    je = jsim.ss.energy
    return ((sim.ss.state.f[:n].double().numpy(), float(e.eion),
             e.virial.double().numpy()),
            (np.asarray(jsim.ss.state.f[:n]), float(je.eion),
             np.asarray(je.virial)), sim)


@pytest.mark.parametrize("two", [False, True], ids=["T1", "T2"])
def test_pair_term_matches_jax(tmp_path, two, monkeypatch):
    """The PAIR term on the kernel branch (species index as type, the
    (T, T) tables, Coulomb off) through cellpair_half_plain against the
    JAX package's f64 force function."""
    calls = []

    def spy(*args, **kw):
        calls.append((args[4].shape[0], kw["coulomb"]))
        return cellpair_half_plain(*args, **kw)

    import ddcmd_tpu_torch.ops.cellpair_half as ch

    monkeypatch.setattr(ch, "cellpair_half_plain", spy)
    jd, td = _pair_decks(tmp_path, edits=(_two_species,) if two else ())
    (f, e, vir), (jf, je, jvir), sim = _term_vs_jax(jd, td)
    T = 2 if two else 1
    assert calls and all(c == (T, False) for c in calls)
    assert sim.force_fn.terms[0].G == 1
    scale = float(np.abs(jf).max())
    assert np.abs(f - jf).max() <= 2e-5 * scale
    assert e == pytest.approx(je, rel=1e-4)
    np.testing.assert_allclose(vir, jvir, rtol=1e-4,
                               atol=1e-4 * np.abs(jvir).max())


def test_nglf_step_matches_jax(tmp_path):
    """One NGLF step of lj_fluid(n=500) with a FREE group (no thermostat
    noise) in both Simulations: positions, forces, energies."""
    jd, td = _pair_decks(tmp_path, edits=(_free,))
    jsim = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64,
                       engine="cellblock")
    jsim.run(1, print_fn=lambda s: None)
    sim = Simulation(*load(td), run_dir=td, device="cpu")
    sim.run(1, print_fn=lambda s: None)
    n = sim.sysdef.state.n_local
    assert sim.ss.loop == int(jsim.ss.loop) == 1
    r, jr = sim.ss.state.r[:n].double().numpy(), np.asarray(
        jsim.ss.state.r[:n])
    L = np.asarray(jsim.ss.box.lengths)
    dr = r - jr
    dr -= L * np.round(dr / L)
    assert np.abs(dr).max() < 1e-5
    jf = np.asarray(jsim.ss.state.f[:n])
    f = sim.ss.state.f[:n].double().numpy()
    assert np.abs(f - jf).max() <= 2e-5 * float(np.abs(jf).max())
    e, je = sim.ss.energy, jsim.ss.energy
    assert float(e.eion) == pytest.approx(float(je.eion), rel=1e-4)
    assert float(e.rk) == pytest.approx(float(je.rk), rel=1e-4)


def test_pair_mesh_first_energy(tmp_path):
    """PAIR under the mesh at (1,1,1) over gloo: the MARTINI kind with
    zero reaction-field constants; its first energy and forces against
    the single-device Simulation's, then one chunk."""
    import torch.distributed as dist

    d = str(tmp_path / "d")
    os.makedirs(d)
    lj_fluid(d, n=N_SMALL)
    sim = Simulation(*load(d), run_dir=d, device="cpu")
    sim.first_energy()
    n = sim.sysdef.state.n_local
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
        assert ps.force_kind == "martini"
        assert ps.tables["keR"] == ps.tables["krf"] == 0.0
        e = ps.first_energy()
        assert e == pytest.approx(float(sim.ss.energy.eion), rel=2e-5)
        f = ps.gather_by_gid(("f",))["f"]
        f0 = sim.ss.state.f[:n].numpy()
        assert np.abs(f - f0).max() <= 2e-5 * float(np.abs(f0).max())
        ps.run(ps.chunk_steps)
        assert ps.loop == ps.chunk_steps and int(ps.mask.sum()) == n
        assert torch.isfinite(ps.f[ps.mask]).all()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("driver", ["simulate", "mesh", "cellblock"])
def test_table_function_raises(tmp_path, driver):
    """A TableFunction PAIR deck raises under auto and on the cell
    engines, naming engine="nlist" (the JAX package evaluates the table
    only on its (N,K)-list engine; its cell engines compute no pair force
    for it).  Under the mesh it runs on the brick list engine through
    pair_lj: in f64 its first energy and forces equal the JAX mesh's
    (its make_brick_step "pairtab" path) to 1e-12, and in f32 it runs a
    chunk."""
    d = str(tmp_path)
    lj_fluid(d, n=64, table=True)
    if driver == "mesh":
        from ddcmd_tpu.run.parallel_sim import \
            ParallelSimulation as JParallelSimulation

        jps = JParallelSimulation(*j_load(d), shape=(1, 1, 1),
                                  dtype=jnp.float64)
        assert jps.force_kind == "pairtab" and jps.shard_engine == "nlist"
        je = jps.first_energy()
        m = np.asarray(jps.mask)
        jf = np.zeros((64, 3))
        jf[np.asarray(jps.fields["gid"])[m][:, 0].astype(np.int64)] = \
            np.asarray(jps.f)[m]
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu",
                                dtype=torch.float64)
        assert ps.force_kind == "pairtab" and ps.shard_engine == "nlist"
        assert abs(ps.first_energy() - je) <= 1e-12 * abs(je)
        f = ps.gather_by_gid(("f",))["f"]
        assert np.abs(f - jf).max() <= 1e-12 * np.abs(jf).max()
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
        ps.run(ps.chunk_steps)
        assert int(ps.mask.sum()) == 64 and torch.isfinite(ps.f).all()
        return
    with pytest.raises(NotImplementedError,
                       match='TableFunction.*engine="nlist"'):
        Simulation(*load(d), run_dir=d, device="cpu",
                   engine="auto" if driver == "simulate" else "cellblock")


def test_jax_cell_engine_drops_table(tmp_path):
    """The reference finding behind that refusal: on a TableFunction deck
    the JAX cell-block engine computes no pair force at all (compile_pair
    fills sigma = eps = 0 for a table and the cell engines read only
    those), while its (N,K)-list engine evaluates the table."""
    d = str(tmp_path)
    j_lj_fluid(d, n=64, table=True)
    out = {}
    for engine in ("cellblock", "nlist"):
        sim = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64,
                          engine=engine)
        sim.first_energy()
        out[engine] = (float(sim.ss.energy.eion),
                       float(np.abs(np.asarray(sim.ss.state.f)).max()))
    assert out["cellblock"] == (0.0, 0.0)
    assert out["nlist"][0] < 0.0 and out["nlist"][1] > 0.0
