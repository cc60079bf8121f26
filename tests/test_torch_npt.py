"""Slice 2 end to end on the small Martini bilayer (528 beads, bonds,
G96 angles, RATTLE, reaction field, semi-anisotropic Berendsen NPT):
one NGLFCONSTRAINT step and a short run through the port's Simulation
(plain twins on the CPU) against the JAX package's, and a checkpoint the
port writes, loaded back by both packages."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_bilayer
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.restart import write_checkpoint
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run import cli
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)


def _free_deck(d, printrate=None):
    """The small bilayer with its thermostat group switched to FREE, so
    both packages' runs are deterministic."""
    os.makedirs(str(d), exist_ok=True)
    martini_bilayer(str(d), nx=4, ny=4, water_nm=1.2)
    p = os.path.join(str(d), "object.data")
    text = open(p).read().replace("type=LANGEVIN; Teq=323.0K; tau=1.0ps;",
                                  "type=FREE;")
    if printrate is not None:
        text = text.replace("printrate=200;", f"printrate={printrate};")
    with open(p, "w") as f:
        f.write(text)
    return str(d)


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """(JAX Simulation on the f64 cell-block engine, the port's CPU
    Simulation), both after first_energy, on the FREE small bilayer.  The
    f64 reference: the JAX f32 engines carry their own ~2e-5 distance
    error (tests/test_torch_slice.py)."""
    d = _free_deck(tmp_path_factory.mktemp("npt"), printrate=2)
    js = JSimulation(*j_load(d), run_dir=d, engine="cellblock",
                     dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu")
    js.first_energy()
    ts.first_energy()
    return js, ts, d


def test_npt_pieces_are_wired(sims):
    _, ts, _ = sims
    assert ts.barostat is not None and not ts.barostat["isotropic"]
    assert ts.constraint_fn is not None and ts.mol_virial_fn is not None
    assert ts.n_molecules == 32 + 144 and ts.sysdef.n_constraints == 32
    assert ts._plan_margin == 1.08


def test_one_npt_step_matches_jax(sims):
    """One NGLFCONSTRAINT step (barostat, front RATTLE, drift, forces,
    back RATTLE) from the same state: box to 1e-6 relative, positions to
    1e-5 nm, velocities to 1e-4 of their scale, energies and virial at
    the pair tests' tolerances."""
    js, ts, _ = sims
    import jax

    jss, jperm, _ = js._build_nbr_jit(js.ss)
    j1 = js.step_fn(jss, jperm, jax.random.PRNGKey(0), js.coeffs)
    tss, tperm, _ = ts._build_nbr(ts.ss)
    zero = torch.zeros((ts.ss.state.n_pad, 3))
    t1 = ts.step_fn(tss, tperm, ts.coeffs, zero, zero)
    np.testing.assert_allclose(t1.box.lengths.numpy(),
                               np.asarray(j1.box.lengths), rtol=1e-6)
    assert not np.allclose(t1.box.lengths.numpy(),
                           ts.ss.box.lengths.numpy(), rtol=1e-7, atol=0)
    np.testing.assert_allclose(t1.state.r.numpy(), np.asarray(j1.state.r),
                               rtol=0, atol=1e-5)
    vj = np.asarray(j1.state.v)
    assert np.abs(t1.state.v.numpy() - vj).max() / np.abs(vj).max() < 1e-4
    assert float(t1.energy.eion) == pytest.approx(float(j1.energy.eion),
                                                  rel=1e-4, abs=1e-2)
    assert float(t1.energy.rk) == pytest.approx(float(j1.energy.rk),
                                                rel=1e-4)
    np.testing.assert_allclose(t1.energy.virial.numpy(),
                               np.asarray(j1.energy.virial), rtol=2e-3,
                               atol=0.5)


def test_short_run_matches_jax_simulation(sims):
    """8 steps through both Simulations (the port's dispatch loop with
    its stale-list redo ladder; the JAX adaptive rebuilds): the printinfo
    rows (energies, T, P, volume, box) to 1e-3 relative, positions to
    1e-3 nm, the box to 1e-5."""
    js, ts, _ = sims
    jrows, trows = [], []
    js.run(8, print_fn=jrows.append, max_steps_per_dispatch=8)
    ts.run(8, print_fn=trows.append, max_steps_per_dispatch=8)
    assert len(trows) == len(jrows) == 4
    for tr, jr in zip(trows, jrows):
        t, j = (np.asarray(x.split(), dtype=np.float64) for x in (tr, jr))
        assert t[0] == j[0]
        np.testing.assert_allclose(t[1:], j[1:], rtol=1e-3, atol=1e-4)
    L = np.asarray(js.ss.box.lengths, np.float64)
    np.testing.assert_allclose(ts.ss.box.lengths.numpy(), L, rtol=1e-5)
    dr = ts.ss.state.r.numpy() - np.asarray(js.ss.state.r)
    dr -= L * np.round(dr / L)
    assert np.abs(dr).max() < 1e-3


def test_checkpoint_loads_in_both_packages(tmp_path):
    """The CLI's simulate master writes snapshots at the deck's
    snapshotrate, and a checkpoint the port writes loads back in the port
    and in the JAX package to the same state: the loop, time, box and
    positions/velocities as written (the ASCII record's 8 decimals in
    Angstrom and Angstrom/fs)."""
    d = _free_deck(tmp_path / "deck")
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read().replace("checkpointrate=50000;",
                                "checkpointrate=50000; snapshotrate=3;")
    with open(p, "w") as f:
        f.write(text)
    run_dir = str(tmp_path / "run")
    sim = cli.run(["simulate", "-o", p, "-n", "6", "--run-dir", run_dir,
                   "--device", "cpu"])
    # snapshots at the deck's snapshotrate: atoms + a 46-byte-record bxyz
    n = sim.ss.state.n_local
    for loop in (3, 6):
        sd = os.path.join(run_dir, f"snapshot.{loop:06d}")
        with open(os.path.join(sd, "bxyz#000000"), "rb") as f:
            blob = f.read()
        assert blob.startswith(b"bxyz FILEHEADER") and b"nrecord=%d" % n in blob
        assert len(blob) - blob.index(b"}\n\n") - 3 == 46 * n
        assert os.path.exists(os.path.join(sd, "atoms#000000"))
    snap = write_checkpoint(sim, d)
    assert os.path.basename(snap) == "snapshot.000006"
    assert os.path.realpath(os.path.join(d, "restart")) == \
        os.path.realpath(os.path.join(snap, "restart"))
    restart = os.path.join(d, "restart")
    ts = TSimulation(*t_load(d, restart=restart), run_dir=d, device="cpu")
    js = JSimulation(*j_load(d, restart=restart), run_dir=d,
                     engine="cellblock")
    for s in (ts, js):
        assert int(s.ss.loop) == 6
        assert float(s.ss.time) == pytest.approx(sim.ss.time, rel=1e-6)
        np.testing.assert_allclose(np.asarray(s.ss.box.lengths),
                                   sim.ss.box.lengths.numpy(), rtol=1e-6)
        # f32 state: 1e-6 nm / 1e-6 nm/ps covers the f32 rounding of the
        # written decimals
        np.testing.assert_allclose(np.asarray(s.ss.state.r)[:n],
                                   sim.ss.state.r.numpy()[:n], atol=1e-6)
        np.testing.assert_allclose(np.asarray(s.ss.state.v)[:n],
                                   sim.ss.state.v.numpy()[:n], atol=1e-6)
    np.testing.assert_array_equal(ts.ss.state.r.numpy(),
                                  np.asarray(js.ss.state.r))
    np.testing.assert_array_equal(ts.ss.state.v.numpy(),
                                  np.asarray(js.ss.state.v))
    np.testing.assert_array_equal(ts.ss.state.gid[:n],
                                  js.ss.state.gid64()[:n])
    # and the restarted port run goes on
    ts.run(2, print_fn=lambda line: None)
    assert ts.ss.loop == 8 and np.isfinite(float(ts.ss.energy.eion))
