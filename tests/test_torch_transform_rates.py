"""Slice 16, transforms in the run (ROADMAP item 24a) on the CPU: the
dispatch cadence of SIMULATE transform= rates and their rescan from
ddcMD_CMDS (against the JAX package in f64), the re-plan of a shrinking
BOX and the engine change of a tilting one, the change from the per-cell kernel #1 to the column kernel #2
when a replica passes the 256-cell gate (their plain versions here), and
ROADMAP item 29: a particle-count change on a deck with a topology
rebuilds it (2x after a replica), where the JAX package keeps the old
topology (the rest of item 29 is tests/test_torch_topology_rebuild.py).

Tolerances: positions within 1e-8 of the box edge and velocities of the
largest |v| after the runs; first energies within 1e-10 relative in
f64, 1e-5 in f32 (8x after a 2x2x2 replica)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_bilayer as j_martini_bilayer
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.restart import write_checkpoint
from ddcmd_tpu_torch.models import martini_water
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)
QUIET = dict(print_fn=lambda line: None)


def _kick_deck(tmp_path, rate):
    """The 300-atom LJ fluid, FREE, with transform= kick: an ADDVELOCITY
    of 1e-4 A/fs in x at `rate`."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    chip_smoke.lj_deck(d, 300, printrate=10, free=True, edit=lambda s: (
        s.replace("type=MD;", "type=MD; transform=kick;", 1)
        + "kick TRANSFORM { type=ADDVELOCITY; velocity=1e-4 0 0 "
        f"Angstrom/fs; rate={rate}; }}\n"))
    return d


def _both(d):
    return (("jax", JSimulation(*j_load(d), run_dir=str(d) + "/j",
                                dtype=jnp.float64)),
            ("torch", TSimulation(*t_load(d), run_dir=str(d) + "/t",
                                  device="cpu", dtype=torch.float64)))


def _count(sim):
    """Record the loop of each apply_transform call of sim."""
    loops = []
    orig = sim.apply_transform

    def counted(tobj):
        loops.append(int(sim.ss.loop))
        return orig(tobj)

    sim.apply_transform = counted
    return loops


def _same_state(js, ts, tol=1e-8):
    n = ts.sysdef.state.n_local
    edge = float(ts.ss.box.h.max())
    np.testing.assert_allclose(ts.ss.state.r[:n].numpy(),
                               np.asarray(js.ss.state.r[:n]), rtol=0,
                               atol=tol * edge)
    jv = np.asarray(js.ss.state.v[:n])
    np.testing.assert_allclose(ts.ss.state.v[:n].numpy(), jv, rtol=0,
                               atol=tol * np.abs(jv).max())


def test_rate_the_cadence_steps_over(tmp_path):
    """Rate 30 on the deck's 20-step rebuild cadence, 60 steps: the
    port's dispatches end on every multiple of the rate (loops 30 and
    60); the JAX package caps its dispatches at 30, runs them as one
    20-step rebuild block, and applies the kick at loop 60 only."""
    d = _kick_deck(tmp_path, 30)
    for where, sim in _both(d):
        os.makedirs(sim.run_dir)
        loops = _count(sim)
        sim.run(60, **QUIET)
        assert int(sim.ss.loop) == 60
        assert loops == {"jax": [60], "torch": [30, 60]}[where]


def test_rescan_moves_the_rate(tmp_path):
    """ddcMD_CMDS after loop 10 re-reads the TRANSFORM (rate 10 -> 20, a
    kick twice as large): both packages apply it at loops 10, 20 and 40
    of a 40-step run, the second kick the new one, and end on the same
    state (f64)."""
    d = _kick_deck(tmp_path, 10)
    sims = dict(_both(d))
    for where, sim in sims.items():
        os.makedirs(sim.run_dir)
        loops = _count(sim)
        with open(os.path.join(sim.run_dir, "ddcMD_CMDS"), "w") as f:
            f.write("kick TRANSFORM { type=ADDVELOCITY; velocity=2e-4 0 0 "
                    "Angstrom/fs; rate=20; }\n")
        sim.run(40, max_steps_per_dispatch=10, **QUIET)
        assert loops == [10, 20, 40], where
    ts = sims["torch"]
    assert [(t, r) for t, _, r in ts.transforms] == [("kick", 20)]
    assert ts.transforms[0][1] is ts.db.get("kick", "TRANSFORM")
    _same_state(sims["jax"], ts)


def test_shrinking_box_replans(tmp_path):
    """A BOX transform that takes the cell edge below rlist (0.75 of the
    1,500-bead water box, 3 cells an axis) re-plans the grid on the fast
    path: its first energy equals a new Simulation's on the checkpoint
    written after it (f64, 1e-10)."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    martini_water(d, n=1500)
    db, base = t_load(d)
    L = 0.75 * float(db.get("box", "BOX").get_floatv("h")[0])     # A
    db.compile_string(f"b TRANSFORM {{ type=BOX; hNew={L} 0 0 0 {L} 0 0 0 "
                      f"{L} Angstrom; }}\n")
    sim = TSimulation(db, base, run_dir=d, device="cpu", dtype=torch.float64)
    sim.first_energy()
    assert sim.grid.ncells == (3, 3, 3)
    sim.apply_transform(db.get("b", "TRANSFORM"))
    assert sim.grid.ncells == (2, 2, 2)
    write_checkpoint(sim, d)
    back = TSimulation(*t_load(d, restart=os.path.join(d, "restart")),
                       run_dir=d, device="cpu", dtype=torch.float64)
    back.first_energy()
    assert float(sim.ss.energy.eion) == pytest.approx(
        float(back.ss.energy.eion), rel=1e-10)


def test_tilting_box_leaves_the_kernels(tmp_path):
    """A BOX transform to a triclinic h on an f32 deck on the kernels (the
    400-bead water box) takes the rebuild path: the engine becomes the
    cell-block one, which takes triclinic boxes, and the first energy
    equals a new Simulation's on the checkpoint written after it (f32,
    1e-5)."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    martini_water(d, n=400)
    db, base = t_load(d)
    L = float(db.get("box", "BOX").get_floatv("h")[0])           # A
    db.compile_string(f"b TRANSFORM {{ type=BOX; hNew={L} {0.1 * L} 0 0 "
                      f"{L} 0 0 0 {L} Angstrom; }}\n")
    sim = TSimulation(db, base, run_dir=d, device="cpu")
    assert sim.engine == "kernel"
    sim.apply_transform(db.get("b", "TRANSFORM"))
    assert sim.engine == "cellblock" and not sim.ss.box.ortho
    write_checkpoint(sim, d)
    back = TSimulation(*t_load(d, restart=os.path.join(d, "restart")),
                       run_dir=d, device="cpu")
    back.first_energy()
    assert back.engine == "cellblock"
    assert float(sim.ss.energy.eion) == pytest.approx(
        float(back.ss.energy.eion), rel=1e-5)


def test_replica_moves_to_the_column_kernel(tmp_path):
    """The water box of 4,100 beads (64 cells: the per-cell kernel #1,
    its plain version here) replicated 2x2x2 by transform= at rate 10 at
    the end of a 10-step run: the same Simulation re-plans to (7, 7, 8),
    392 cells, past the 256-cell gate, and takes the column kernel #2 at
    G = 4; its first energy is 8x the energy before (f32, 1e-5) and the
    gids stay unique."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    martini_water(d, n=4100)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(text.replace("type=MD;", "type=MD; transform=rep;", 1)
                + "rep TRANSFORM { type=REPLICATE; nx=2; ny=2; nz=2; "
                "rate=10; }\n")
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu")
    assert sim.engine == "kernel" and sim.force_fn.terms[0].G == 1
    energies = []
    orig = sim.apply_transform

    def spy(tobj):
        energies.append(float(sim.ss.energy.eion))
        orig(tobj)
        energies.append(float(sim.ss.energy.eion))

    sim.apply_transform = spy
    sim.run(10, **QUIET)
    n = sim.sysdef.state.n_local
    assert n == 8 * 4100 and int(sim.ss.loop) == 10
    assert sim.engine == "kernel" and sim.force_fn.terms[0].G == 4
    assert sim.grid.ncells == (7, 7, 8)
    assert energies[1] == pytest.approx(8.0 * energies[0], rel=1e-5)
    assert len(set(sim.sysdef.collection.gid)) == n


@pytest.mark.parametrize("deck", ["bilayer", "water"])
def test_count_change_on_a_topology_is_item_29(tmp_path, deck):
    """REPLICATE nz=2 in f64: on the 672-bead bilayer (bonds, angles,
    exclusions, RATTLE constraints, three-bead and larger molecules) the
    port builds the topology anew and its eion goes 2x (1e-10), the
    bonded counts and the constraints too, where the JAX package's goes
    ~1.28x (its rebuild keeps the old bonded terms and exclusions: only
    the first copy keeps them; the finding behind item 29); the water
    box of 1,500 beads, which has none, gives 2x in both (1e-10)."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    if deck == "bilayer":
        j_martini_bilayer(d, nx=4, ny=4)
    else:
        martini_water(d, n=1500)
    sims = [("jax", JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)),
            ("torch", TSimulation(*t_load(d), run_dir=d, device="cpu",
                                  dtype=torch.float64))]
    for where, sim in sims:
        sim.first_energy()
        e0 = float(sim.ss.energy.eion)
        c0 = sim.sysdef.bonded.counts()
        sim.db.compile_string("rep TRANSFORM { type=REPLICATE; nz=2; }\n")
        sim.apply_transform(sim.db.get("rep", "TRANSFORM"))
        ratio = float(sim.ss.energy.eion) / e0
        if deck == "water" or where == "torch":
            assert ratio == pytest.approx(2.0, rel=1e-10), where
        else:
            assert 1.2 < ratio < 1.4, ratio
        if where == "torch":
            assert sim.sysdef.bonded.counts() == {k: 2 * v
                                                  for k, v in c0.items()}
            assert sim.sysdef.n_constraints == c0["n_constraints"] * 2
