"""Slice 13, the CHARMM decks through the drivers, against the JAX
package: the c36 solvated tripeptide (tests/test_charmm_c36.py:
make_solvated_fixture, L = 20 A, max_w = 24) through
Simulation(engine="nlist") in f64 with its finite-difference forces and
the engine choice (auto demotes it to the list); the ethane fluid
(tests/test_charmm.py:make_fixture) at 216 molecules in 4.0 nm on the
per-cell kernel's plain twin and through the mesh at (1,1,1) over gloo;
the chains under the mesh on both engines; chip_smoke.py's deck writers.
tests/test_torch_charmm.py holds the host layer and the evaluators.

Tolerances: the f64 first energy rel 1e-9 and forces 1e-9 of the scale;
finite differences (h = 1e-6 nm) rel 3e-5, abs 2e-3, as
test_c36_fd_forces; the f32 kernel twin against JAX's f64 list engine on
the same state at the LJ gates (force 2e-5 of the scale, e rel 1e-4);
the mesh's first energy rel 2e-5 of Simulation's; decks byte for byte.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from test_charmm import make_chain_fixture, make_fixture
from test_charmm_c36 import make_solvated_fixture

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSim
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
from ddcmd_tpu_torch.run.simulate import Simulation as TSim

torch.set_num_threads(2)


def _c36(d):
    make_solvated_fixture(d, L=20.0, max_w=24)
    return str(d)


def _tsim(d, **kw):
    return TSim(*t_load(d), run_dir=d, device="cpu", **kw)


def _close(got, ref, tol, what):
    """got within tol of ref's scale (max |ref|)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def c36(tmp_path_factory):
    """(deck dir, JAX f64 list Simulation, port f64 list Simulation),
    both after their first energy."""
    d = _c36(tmp_path_factory.mktemp("c36"))
    js = JSim(*j_load(d), run_dir=d, dtype=jnp.float64, engine="nlist")
    js.first_energy()
    ts = _tsim(d, dtype=torch.float64, engine="nlist")
    ts.first_energy()
    return d, js, ts


def test_fd_forces_c36(c36):
    """Forces on the list engine in f64 against central differences of
    the energy (h = 1e-6 nm) at the atoms tests/test_charmm_c36.py's
    test_c36_fd_forces picks: the termini, the CMAP backbone, a water."""
    _, _, ts = c36
    ss, nbr, ov = ts._build_nbr(ts.ss)
    assert not bool(ov)
    f, e0, _, _ = ts.force_fn(ss.state, ss.box, nbr)
    assert np.isfinite(float(e0))
    h = 1e-6
    for i in (0, 1, 13, 15, 17, 26, 28, 30, 31):
        for ax in range(3):
            es = []
            for sgn in (1.0, -1.0):
                r = ss.state.r.clone()
                r[i, ax] += sgn * h
                es.append(float(ts.force_fn(ss.state.replace(r=r), ss.box,
                                            nbr)[1]))
            fd = -(es[0] - es[1]) / (2 * h)
            assert float(f[i, ax]) == pytest.approx(fd, rel=3e-5, abs=2e-3), \
                (i, ax)


def test_simulation_nlist_equals_jax(c36):
    """The c36 tripeptide through Simulation(engine="nlist") in f64: the
    first energy within rel 1e-9 of JAX's, the forces within 1e-9 of
    the scale; auto demotes it to the list with the JAX warning and the
    cell engines raise for its 30-member chain component; 10 port steps
    stay finite."""
    d, js, ts = c36
    n = ts.sysdef.state.n_local
    assert float(ts.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-9)
    _close(ts.ss.state.f[:n].numpy(), np.asarray(js.ss.state.f[:n]), 1e-9,
           "f")
    with pytest.warns(UserWarning, match="30-member component"):
        assert _tsim(d).engine == "nlist"
    for eng in ("kernel", "cellblock"):
        with pytest.raises(ValueError, match="exclusion component of 30"):
            _tsim(d, engine=eng)
    ts.run(10, print_fn=lambda line: None)
    assert np.isfinite(float(ts.ss.energy.eion))


# ---------------------------------------------------------------------------
# the ethane fluid on the kernels' plain twin and through the mesh
# ---------------------------------------------------------------------------

def test_ethane_kernel_twin_vs_jax_list(tmp_path):
    """216 molecules in 4.0 nm (1,728 atoms): auto in f32 picks the
    kernels, plan (3,3,3) cap 128, the per-cell kernel #1 (its plain twin
    on the CPU) with exclusion channels; its first energy and forces
    against JAX's f64 list engine at the LJ gates."""
    d = str(tmp_path)
    make_fixture(tmp_path, n_mol=216, L=4.0)
    ts = _tsim(d)
    term = ts.force_fn.terms[0]
    assert ts.engine == "kernel" and term.G == 1
    assert ts.grid.ncells == (3, 3, 3) and ts.grid.cap == 128
    ts.first_energy()
    # the f64 reference on the same state: the f32 deck's positions (their
    # f32 rounding alone moves the bonded forces by ~6e-5 of the scale)
    js = JSim(*j_load(d), run_dir=d, dtype=jnp.float64, engine="nlist")
    n = ts.sysdef.state.n_local
    r = np.asarray(js.ss.state.r).copy()
    r[:n] = ts.sysdef.state.r[:n].double().numpy()
    js.ss = js.ss.replace(state=js.ss.state.replace(r=jnp.asarray(r)))
    js.first_energy()
    assert float(ts.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-4)
    _close(ts.ss.state.f[:n].numpy(), np.asarray(js.ss.state.f[:n]), 2e-5,
           "f")


def test_ethane_mesh_first_energy(tmp_path):
    """The 216-molecule ethane deck through ParallelSimulation at (1,1,1)
    over gloo (batched torsions, bonded LJ pairs and exclusions under the
    ownership weights, the extended-grid kernel's twin with exclusions):
    first energy within rel 2e-5 of Simulation's, then one chunk with
    finite forces."""
    import torch.distributed as dist

    d = str(tmp_path / "d")
    os.makedirs(d)
    make_fixture(tmp_path / "d", n_mol=216, L=4.0)
    sim = _tsim(d)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
        e = ps.first_energy()
        assert e == pytest.approx(float(sim.ss.energy.eion), rel=2e-5)
        ps.run(ps.chunk_steps)
        assert ps.loop == ps.chunk_steps and int(ps.mask.sum()) == n
        assert torch.isfinite(ps.f[ps.mask]).all()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["c36", "chain"])
def test_mesh_refuses_chains(tmp_path, kind):
    """Under the mesh CHARMM chains run: the c36 tripeptide (its
    30-member exclusion component) on the brick list engine, the 12-atom
    chain (narrow enough for the channels) with its junction and CMAP
    terms resolved per term by gid.  In f64 (the list engine) the mesh's
    first energy and forces at (1,1,1) match the JAX package's f64
    Simulation on its list engine (rel 1e-9, 1e-9 of the scale); in f32
    (c36: the list engine; the chain: the cells engine, #6's plain
    version, with the per-term leftovers beside it) at the list engine's
    f32 gates against f64 (e rel 1e-4, forces 3e-4 of the scale), then
    one chunk with finite forces."""
    if kind == "c36":
        d = _c36(tmp_path)
    else:
        make_chain_fixture(tmp_path)
        d = str(tmp_path)
    js = JSim(*j_load(d), run_dir=d, dtype=jnp.float64, engine="nlist")
    js.first_energy()
    e0 = float(js.ss.energy.eion)
    ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu",
                            dtype=torch.float64)
    assert ps.shard_engine == "nlist" and ps._bonded_left is not None
    n = ps.sysdef.state.n_local
    f0 = np.asarray(js.ss.state.f[:n], np.float64)
    assert ps.first_energy() == pytest.approx(e0, rel=1e-9)
    _close(ps.gather_by_gid(("f",))["f"], f0, 1e-9, "f64 f")
    ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
    assert ps.shard_engine == ("nlist" if kind == "c36" else "pallas")
    assert ps.first_energy() == pytest.approx(e0, rel=1e-4)
    _close(ps.gather_by_gid(("f",))["f"], f0, 3e-4, "f32 f")
    ps.run(ps.chunk_steps)
    assert int(ps.mask.sum()) == n and torch.isfinite(ps.f[ps.mask]).all()


# ---------------------------------------------------------------------------
# chip_smoke.py's decks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ethane", "ethane216", "c36", "c36nve"])
def test_chip_smoke_decks_equal_fixtures(tmp_path, kind):
    """charmm_ethane_deck and charmm_tripeptide_deck write the JAX
    fixtures' files byte for byte."""
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jd.mkdir()
    td.mkdir()
    if kind.startswith("ethane"):
        kw = dict(n_mol=216, L=4.0) if kind == "ethane216" else {}
        make_fixture(jd, **kw)
        chip_smoke.charmm_ethane_deck(str(td), **kw)
    else:
        kw = dict(nve=True, dt_fs=0.25) if kind == "c36nve" else {}
        make_solvated_fixture(jd, **kw)
        chip_smoke.charmm_tripeptide_deck(str(td), **kw)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
