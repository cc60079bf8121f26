"""Slice 1 end to end: the Martini water box through the port's
Simulation (plain twin on CPU) against the JAX package's Simulation on
the cell-block engine, and the port's CLI printinfo output."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_water
from ddcmd_tpu.run.printinfo import PrintInfo as JPrintInfo
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run import cli
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)


def _free_deck(d, n, printrate=None):
    """martini_water with the thermostat group switched to FREE, so both
    runs are deterministic."""
    os.makedirs(str(d), exist_ok=True)
    martini_water(str(d), n=n)
    p = os.path.join(str(d), "object.data")
    text = open(p).read().replace("type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
                                  "type=FREE;")
    if printrate is not None:
        text = text.replace("printrate=100;", f"printrate={printrate};")
    with open(p, "w") as f:
        f.write(text)
    return str(d)


# n=400: 2 cells per axis, where stencil directions alias one cell
# through two periodic images; n=1600: 3 cells per axis
@pytest.mark.parametrize("n,ncells", [(400, (2, 2, 2)), (1600, (3, 3, 3))])
def test_slice_matches_jax_simulation(tmp_path, n, ncells):
    d = _free_deck(tmp_path, n, printrate=10)
    jdb, base = j_load(d)
    tdb, _ = t_load(d)
    # the reference runs in f64: the JAX cell-block engine's f32
    # |p|^2+|q|^2-2pq distances carry ~2e-5 of force scale themselves,
    # about 2.5x the port's error against the same f64 forces
    jsim = JSimulation(jdb, base, run_dir=d, engine="cellblock",
                       dtype=jnp.float64)
    tsim = TSimulation(tdb, base, run_dir=d, device="cpu")
    assert tsim.grid.ncells == ncells

    jsim.first_energy()
    tsim.first_energy()
    fj = np.asarray(jsim.ss.state.f)
    scale = max(1.0, float(np.abs(fj).max()))
    assert np.abs(tsim.ss.state.f.numpy() - fj).max() / scale < 2e-5

    jrows, trows = [], []
    jsim.run(40, print_fn=jrows.append, max_steps_per_dispatch=40)
    tsim.run(40, print_fn=trows.append, max_steps_per_dispatch=40)
    je, te = jsim.ss.energy, tsim.ss.energy
    assert float(te.eion) == pytest.approx(float(je.eion), rel=1e-4, abs=1e-2)
    assert float(te.rk) == pytest.approx(float(je.rk), rel=1e-3, abs=1e-2)
    # positions agree modulo the wrap convention (compare via min-image)
    L = np.asarray(jsim.ss.box.lengths, dtype=np.float64)
    dr = tsim.ss.state.r.numpy() - np.asarray(jsim.ss.state.r)
    dr -= L * np.round(dr / L)
    assert np.abs(dr).max() < 1e-3

    # the printinfo rows: same loops and times, same energies per bead
    assert len(trows) == len(jrows) == 4
    for tr, jr in zip(trows, jrows):
        t, j = (np.asarray(x.split(), dtype=np.float64) for x in (tr, jr))
        assert t[0] == j[0]
        np.testing.assert_allclose(t[1:], j[1:], rtol=1e-3, atol=1e-4)


def test_cli_writes_printinfo_data(tmp_path):
    """`cli simulate` writes the printinfo `data` file: the JAX package's
    header and one 11-column row per printrate step."""
    d = _free_deck(tmp_path / "deck", 400, printrate=5)
    run_dir = str(tmp_path / "run")
    sim = cli.run(["simulate", "-o", os.path.join(d, "object.data"),
                   "-n", "20", "--run-dir", run_dir, "--device", "cpu"])
    assert sim.ss.loop == 20
    with open(os.path.join(run_dir, "data")) as f:
        lines = f.read().splitlines()
    jdb, _ = j_load(d)
    assert lines[0] == JPrintInfo.from_deck(jdb, None).header()
    rows = [np.asarray(x.split(), dtype=np.float64) for x in lines[1:]]
    assert [int(r[0]) for r in rows] == [5, 10, 15, 20]
    assert all(r.shape == (11,) and np.isfinite(r).all() for r in rows)


def test_cli_refuses_unported_masters(tmp_path):
    """Every master runs since slice 17: `cli analysis` on the FREE water
    box evaluates and writes the SIMULATE analysis= list once after the
    first energy, its centre-of-mass row the start state's."""
    d = _free_deck(tmp_path / "deck", 400)
    p = os.path.join(d, "object.data")
    text = open(p).read().replace("type=MD;", "type=MD; analysis=vcm;", 1)
    with open(p, "w") as f:
        f.write(text + "vcm ANALYSIS { type=VCMWRITE; }\n")
    run_dir = str(tmp_path / "run")
    sim = cli.run(["analysis", "-o", p, "--run-dir", run_dir, "--device",
                   "cpu"])
    st = sim.ss.state
    m, v = st.mass[:400, None].double(), st.v[:400].double()
    row = np.loadtxt(os.path.join(run_dir, "vcm.data"))
    assert row[0] == 0 and row.shape == (4,)
    np.testing.assert_allclose(row[1:], ((m * v).sum(0) / m.sum()).numpy(),
                               rtol=1e-5, atol=1e-9)


def test_overflow_replans_and_recovers(tmp_path):
    """A cell capacity too small for the occupancy overflows at the first
    rebuild; the ladder grows the density safety, replans (never below
    the old cap) and the run completes on a grid that holds every bead."""
    from ddcmd_tpu_torch.run.forces import build_force_fn
    from ddcmd_tpu_torch.integrators.nglf import make_nglf_step

    d = _free_deck(tmp_path, 400)
    sim = TSimulation(t_load(d)[0], d, run_dir=d, device="cpu")
    sim.grid = sim.grid.with_cap(32)
    sim.force_fn = build_force_fn(sim.sysdef, sim.grid)
    sim.step_fn = make_nglf_step(sim.force_fn, sim.sysdef.cfg.dt)
    sim.run(10, print_fn=lambda line: None)
    assert sim.ss.loop == 10
    assert sim.grid.cap >= 64 and sim._density_safety > 1.3
    _, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov)
    assert int((perm < sim.ss.state.n_pad).sum()) == 400


def test_non_finite_energy_trips_kill_switch(tmp_path):
    d = _free_deck(tmp_path, 400)
    sim = TSimulation(t_load(d)[0], d, run_dir=d, device="cpu")
    r = sim.ss.state.r.clone()
    r[1] = r[0]                      # two beads on one site: infinite LJ
    sim.ss = sim.ss.replace(state=sim.ss.state.replace(r=r))
    with pytest.raises(FloatingPointError, match="kill switch"):
        sim.run(5, print_fn=lambda line: None)
