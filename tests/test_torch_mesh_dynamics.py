"""Item 22's dynamics under the brick mesh: ParallelSimulation runs the
NVE variants, NPTGLF, NGLFNK, box(t) (STRAIN, DEFORMATION_RATE, VOLUME),
EXTFORCE, the hook groups (SHEAR, SHWALL, DOUBLE_MIRROR, UNIONGROUP),
Teq and PISTON vz schedules, GLOBAL_ENERGY targets and NGLFNEW with
constraints as the port's Simulation does.

One two-rank gloo spawn at (1,1,2), so the z split crosses the SHEAR
slices (chip_smoke.mesh_dynamics_decks puts the top one across z = 0 and
the bottom one across the periodic seam) and every all-reduce of a step
is a real one; while the ranks run, the test process runs each deck's
Simulation (f64, engine "nlist", which wraps positions after every
drift as the mesh's list engine does) and the JAX package's Simulation
on the NPTGLF deck.  The decks' updateRate is 10 and their printrate
10: the mesh's dispatches are its 10-step chunks (and, with two groups,
end on printrate), Simulation's are capped at 10 steps
(max_steps_per_dispatch), so both drivers' dispatches end at the same
loops and both refresh the group coefficients once a dispatch at the
same times.

Every parity deck draws no noise (the mesh's draws are per rank, so
they cannot equal Simulation's row for row): FREE groups, NVEGLF's
LANGEVIN group (the NVE variants kick with plain leapfrog
coefficients), NGLFNK at a 0 K target (its draws' amplitude is zero).
The GLOBAL_ENERGY deck runs under Langevin noise and is held in its
live Teq only.

The same spawn runs five of the decks in f32 on a box wide enough for
the cells engine (the engine of TPU kernels #6 and #7, here through
their plain versions): NPTGLF, NGLFNK, STRAIN, SHEAR and EXTFORCE.  It
keeps rows unwrapped between migrations and moves its frozen cell grid
with the box, so it is held to Simulation's f32 kernel engine after the
same 20 steps.

Tolerances: after 20 f64 steps the mesh equals Simulation to 1e-10 of
each quantity's scale (positions modulo the box, velocities, h, zeta,
bdot, e_pot, the virial); the live Teq to 1e-10 relative; the NPTGLF
deck against the JAX Simulation (its fixed rebuild cadence,
DDCMD_FIXED_REBUILD=1) to 1e-9 relative in volume, zeta, e_pot and the
kinetic energy.  The f32 legs: positions 1e-4 nm and velocities 1e-3
of their scale (as tests/test_torch_mesh_groups.py holds the affine
kinds), h 1e-6 of its scale, zeta, bdot, e_pot, the kinetic energy and
the virial 1e-4 of theirs.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import torch_mesh_ranks as ranks
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.run.simulate import Simulation

torch.set_num_threads(2)

STEPS = 20
# 256 atoms: a 2.3 nm box, two z bricks of 1.15 nm (each leg ~1.3 s on
# two ranks)
DECKS = dict(chip_smoke.mesh_dynamics_decks(n=256))
NOISY = ("GLOBAL_ENERGY",)
PARITY = [k for k in DECKS if k not in NOISY]
# the legs whose checkpoint the mesh restarts from
RESTARTS = ("NPTGLF", "NGLFNK")
# the f32 cells-engine legs: 1,400 atoms, a 4.05 nm box, so each z brick
# (2.03 nm) holds the 2 rlist (1.94 nm) a two-brick axis needs
F32_N = 1400
F32 = {f"F32_{k}": make for k, make in chip_smoke.mesh_dynamics_decks(
    n=F32_N) if k in ("NPTGLF", "NGLFNK", "STRAIN", "SHEAR", "EXTFORCE")}


def _sim(d, steps=STEPS, f32=False):
    """The deck's Simulation on the CPU in f64 (engine "nlist"; in f32
    its kernel engine), `steps` steps in dispatches of at most 10 (the
    compressing decks' stale-list warnings silenced)."""
    sim = (Simulation(*load(d), run_dir=d, device="cpu") if f32 else
           Simulation(*load(d), run_dir=d, device="cpu",
                      dtype=torch.float64, engine="nlist"))
    if steps:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sim.run(steps, print_fn=lambda line: None,
                    max_steps_per_dispatch=10)
    return sim


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{deck: the mesh's results}, {deck: its Simulation}, and the JAX
    Simulation on the NPTGLF deck."""
    root = tmp_path_factory.mktemp("dynamics")
    decks = {}
    for name, make in (*DECKS.items(), *F32.items()):
        d = str(root / name)
        os.makedirs(d)
        make(d)
        decks[name] = d
    jd = str(root / "jax_nptglf")
    shutil.copytree(decks["NPTGLF"], jd)
    out = str(root / "mesh.npz")
    join = ranks.start_ranks(ranks.mesh_dynamics, 2, root, decks, STEPS, out,
                             RESTARTS, tuple(F32))
    try:
        sims = {name: _sim(decks[name]) for name in PARITY}
        sims.update({name: _sim(decks[name], f32=True) for name in F32})
        sims["GLOBAL_ENERGY"] = _sim(decks["GLOBAL_ENERGY"], steps=0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DDCMD_FIXED_REBUILD", "1")
            js = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64)
            js.run(STEPS, print_fn=lambda line: None)
    finally:
        join()
    return dict(np.load(out)), sims, js


def _close(got, ref, what, tol=1e-10):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("deck", PARITY)
def test_mesh_matches_simulation(runs, deck):
    """20 f64 steps at (1,1,2): positions (modulo the box), velocities,
    h, zeta, bdot, e_pot and the virial equal Simulation's to 1e-10 of
    their scale; both bricks own rows, the run ended at loop 20 after
    dispatches ending on 10 and 20."""
    mesh, sims, _ = runs
    sim = sims[deck]
    m = {k[len(deck) + 1:]: v for k, v in mesh.items()
         if k.startswith(deck + "_")}
    ss = sim.ss
    n = sim.sysdef.state.n_local
    h = ss.box.h.numpy()
    assert int(m["loop"]) == ss.loop == STEPS
    assert m["ends"].tolist() == [10, 20]
    assert len(m["owned"]) == 2 and m["owned"].min() > 0
    assert m["owned"].sum() == n
    assert str(m["engine"]) == "nlist"
    s = (m["r"] - ss.state.r[:n].numpy()) @ np.linalg.inv(h).T
    dr = float(np.abs((s - np.round(s)) @ h.T).max())
    assert dr <= 1e-10 * np.abs(h).max(), ("r", dr)
    _close(m["v"], ss.state.v[:n].numpy(), "v")
    _close(m["h"], h, "h")
    _close(float(m["zeta"]), float(ss.zeta), "zeta")
    _close(m["bdot"], ss.bdot.numpy(), "bdot")
    _close(float(m["e"]), float(ss.energy.eion), "e_pot")
    _close(m["virial"], ss.energy.virial.numpy(), "virial")
    moves = sim.sysdef.integrator_type in ("NPTGLF", "NGLFNK", "NGLFNEW") \
        or sim.sysdef.box_time is not None
    assert np.allclose(h, sim.sysdef.box.h.numpy(), rtol=1e-9,
                       atol=0) != moves


@pytest.mark.parametrize("deck", list(F32))
def test_cells_engine_matches_simulation(runs, deck):
    """20 f32 steps at (1,1,2) on the cells engine against Simulation's
    kernel engine: positions (modulo the box) 1e-4 nm, velocities 1e-3
    of their scale, h 1e-6, zeta, bdot, e_pot, the kinetic energy and
    the virial 1e-4; both bricks own rows, dispatches ending on 10 and
    20, the box moved where the deck moves it."""
    mesh, sims, _ = runs
    sim = sims[deck]
    m = {k[len(deck) + 1:]: v for k, v in mesh.items()
         if k.startswith(deck + "_")}
    ss = sim.ss
    n = sim.sysdef.state.n_local
    h = ss.box.h.double().numpy()
    assert str(m["engine"]) == "pallas" and sim.engine == "kernel"
    assert int(m["loop"]) == ss.loop == STEPS
    assert m["ends"].tolist() == [10, 20]
    assert len(m["owned"]) == 2 and m["owned"].min() > 0
    assert m["owned"].sum() == n
    s = (m["r"] - ss.state.r[:n].double().numpy()) @ np.linalg.inv(h).T
    dr = float(np.abs((s - np.round(s)) @ h.T).max())
    assert dr <= 1e-4, ("r", dr)
    _close(m["v"], ss.state.v[:n].double().numpy(), "v", 1e-3)
    _close(m["h"], h, "h", 1e-6)
    _close(float(m["zeta"]), float(ss.zeta), "zeta", 1e-4)
    _close(m["bdot"], ss.bdot.double().numpy(), "bdot", 1e-4)
    _close(float(m["e"]), float(ss.energy.eion), "e_pot", 1e-4)
    _close(float(m["rk"]), float(ss.energy.rk), "rk", 1e-4)
    _close(m["virial"], ss.energy.virial.double().numpy(), "virial", 1e-4)
    moves = deck in ("F32_NPTGLF", "F32_NGLFNK", "F32_STRAIN")
    assert np.allclose(h, sim.sysdef.box.h.double().numpy(), rtol=1e-6,
                       atol=0) != moves


def test_global_energy_live_teq_matches_simulation(runs):
    """The GLOBAL_ENERGY deck under Langevin noise: the mesh's first
    energy equals Simulation's (1e-10), and the live Teq of its last
    coefficient refresh equals what Simulation's refresh computes from
    the same energy (1e-10 relative), away from the deck's 120 K."""
    mesh, sims, _ = runs
    sim = sims["GLOBAL_ENERGY"]
    sim.first_energy()
    _close(float(mesh["GLOBAL_ENERGY_e0"]), float(sim.ss.energy.eion),
           "e0")
    assert np.isfinite(mesh["GLOBAL_ENERGY_r"]).all()
    assert int(mesh["GLOBAL_ENERGY_loop"]) == STEPS
    g = sim.sysdef.groups[0]
    # the first refresh pins the bath's total at the first energy
    assert sim._ge_teq_override()[g.index] == pytest.approx(120.0, rel=1e-12)
    sim._eion_last = float(mesh["GLOBAL_ENERGY_ge_e"])
    teq = sim._ge_teq_override()[g.index]
    got = float(mesh["GLOBAL_ENERGY_ge_noise"][g.index]) * g.tau \
        / (2.0 * U.kB)
    assert got == pytest.approx(teq, rel=1e-10, abs=0)
    assert abs(teq - 120.0) > 1e-6


def test_nptglf_matches_jax_simulation(runs):
    """The NPTGLF deck under the port's mesh at (1,1,2) against the JAX
    package's Simulation: volume, zeta, e_pot and the kinetic energy
    after 20 f64 steps to 1e-9 relative, the box moved."""
    mesh, sims, js = runs
    h = mesh["NPTGLF_h"]
    jh = np.asarray(js.ss.box.h, np.float64)
    assert abs(np.linalg.det(h) / np.linalg.det(jh) - 1.0) <= 1e-9
    assert float(mesh["NPTGLF_zeta"]) == pytest.approx(
        float(js.ss.zeta), rel=1e-9, abs=0)
    assert float(mesh["NPTGLF_e"]) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-9, abs=0)
    assert float(mesh["NPTGLF_rk"]) == pytest.approx(
        float(js.ss.energy.rk), rel=1e-9, abs=0)
    assert float(js.ss.zeta) != 0.0
    assert not np.allclose(jh, np.asarray(sims["NPTGLF"].sysdef.box.h),
                           rtol=1e-6, atol=0)


@pytest.mark.parametrize("deck", RESTARTS)
def test_checkpoint_carries_zeta_and_bdot(runs, deck):
    """The mesh's checkpoint after 20 steps writes NPTGLF's zeta and
    NGLFNK's piston velocities, and a mesh restarted from it reads them
    back (rel 1e-11, the restart file's %.12e text) at loop 20; they
    moved from the deck's 0."""
    mesh, _, _ = runs
    assert int(mesh[f"{deck}_restart_loop"]) == STEPS
    zeta, bdot = float(mesh[f"{deck}_zeta"]), mesh[f"{deck}_bdot"]
    assert float(mesh[f"{deck}_restart_zeta"]) == pytest.approx(
        zeta, rel=1e-11, abs=0)
    np.testing.assert_allclose(mesh[f"{deck}_restart_bdot"], bdot,
                               rtol=1e-11, atol=0)
    assert (zeta != 0.0) == (deck == "NPTGLF")
    assert np.any(bdot != 0.0) == (deck == "NGLFNK")
