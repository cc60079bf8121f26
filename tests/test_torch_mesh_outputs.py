"""ParallelSimulation.run(migrate_rate=) and SIMULATE's outputs at their
rates under the brick mesh, over two gloo ranks at (2,1,1), against the
JAX package.

One spawn runs every leg (tests/torch_mesh_ranks.mesh_outputs) while
this process computes the JAX references:

  * migrate_rate under NVT (per-step dispatch, a migration on each loop
    it divides) on the FREE f64 water box: positions by gid equal to the
    JAX mesh's after 3 migrate_rate steps (1e-10); under the barostat
    (the chunk length) the loop and the box of tests/test_brick.py:
    153-158's case against the JAX mesh (1e-10);
  * a hot FREE LJ fluid whose rows leave their bricks between
    migrations, on the list engine (f64) and the cells engine (f32, the
    plain path of #6): at every step the mesh's energy and forces equal
    the single-device list's (1e-10 of the force scale in f64, 2e-5 in
    f32); the drift guard flags and the host redistributes, so no pair
    is lost;
  * a FREE f64 water deck with every registry analysis, printStress,
    printGraphs and two groups, 40 steps: every analysis file, the
    stress and the group files against the JAX Simulation's at the chip
    script's masters_agree tolerances (numbers within AN_FLOAT_TOL of
    their column's largest magnitude, chip_smoke.outputs_agree), the
    graphs' columns and nlocal;
    vcm30 (eval_rate 30 on the 20-step cadence, which the JAX run loop
    steps over) against the port's Simulation.
"""

import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.cli import load_db as j_load_db
from ddcmd_tpu.run.parallel_sim import ParallelSimulation as JParallel
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
from test_torch_analysis_run import ANALYSES

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

NVT_R = 5               # the NVT leg's migrate_rate (chunk_steps is 20)
NPT_K = 6               # the NPT leg's updateRate
HOT_R = 40
# the hot fluids at (2,1,1): the cells engine's on a (12, 9, 9) lattice
# (bricks of 21.6 A, at least 2 rlist; three cells on y and z), the list
# engine's on an (18, 7, 7) one (bricks of 32.4 A): lattice, steps, K
HOT = {"cells": ((12, 9, 9), 25, 1500.0), "list": ((18, 7, 7), 24, 6000.0)}
OUT_STEPS = 40
QUIET = dict(print_fn=lambda line: None)


def _hot_deck(d, T, sites):
    """A FREE LJ fluid deck (lj_deck: 8.5 A cutoff, 1.2 A skin, 4 fs)
    whose atoms sit on a jittered lattice of `sites` (mx, my, mz) at 3.6
    A a site (0.0214 / A^3) in the box it fills, with layers on the brick
    faces of (2,1,1), so rows cross them from the first steps;
    velocities at T.  (18, 7, 7) makes bricks of 32.4 A, whose halo
    windows (rlist 9.7 A from each face) leave 13 A of interior that a
    neighbour never sees, so a row that strays past the skin loses pairs
    unless the drift guard stops it."""
    from ddcmd_tpu_torch.models.builders import write_atoms

    n = int(np.prod(sites))
    chip_smoke.lj_deck(d, n, printrate=100, free=True)
    rng = np.random.default_rng(11)
    L = 3.6 * np.asarray(sites, np.float64)
    g = np.stack(np.meshgrid(*[np.arange(m) for m in sites],
                             indexing="ij"), -1).reshape(-1, 3)
    r = g * 3.6 - L / 2 + (rng.random(g.shape) - 0.5) * 0.4
    kT = 8.617333e-5 * T / (39.948 * 103.64)        # (A/fs)^2
    v = rng.standard_normal(r.shape) * np.sqrt(kT)
    write_atoms(os.path.join(d, "atoms#000000"), r, v, ["Ar"] * n,
                ["free"] * n, np.diag(L))
    chip_smoke.edit_deck(os.path.join(d, "object.data"), lambda text: re.sub(
        r"h= [^;]*;", "h= %.6f 0 0 0 %.6f 0 0 0 %.6f ;" % tuple(L), text))
    return d


def _outputs_deck(d):
    """The FREE 400-bead water deck with every registry analysis (rates
    20 / 40, vcm30 at 30 / 60), printStress, printGraphs and two groups
    (x < 0 and the rest) at printrate 20."""
    deck = chip_smoke.water_deck(d, 400, printrate=20, free=True)
    chip_smoke.edit_deck(deck, lambda s: chip_smoke.analyses_edit(
        ANALYSES, print_stress=True)(s).replace(
            "printStress=1;", "printStress=1; printGraphs=1;"))
    chip_smoke.regroup(d, {"solvent": "type=FREE;", "half": "type=FREE;"},
                       lambda r: np.where(r[:, 0] < 0, "solvent", "half"),
                       printrate=20)
    return d


def _jax_mesh(d):
    return JParallel(j_load_db([os.path.join(d, "object.data")], None, d),
                     d, shape=(2, 1, 1), dtype=jnp.float64)


def _jax_nvt(d):
    """The JAX mesh's per-step path: 3 NVT_R steps, migrate_rate NVT_R."""
    jps = _jax_mesh(d)
    jps.first_energy()
    jps.run(3 * NVT_R, migrate_rate=NVT_R, **QUIET)
    return dict(nvt_r=_jax_by_gid(jps), nvt_loop=jps.loop)


def _jax_npt(d):
    """The JAX mesh on the Berendsen deck: 2 k + 3 loops (chunks and a
    remainder chunk of 3), then 2 h with migrate_rate = h = k / 2 (a
    chunk of h: with k = NPT_K the remainder's program)."""
    jps = _jax_mesh(d)
    jps.first_energy()
    k = jps.chunk_steps
    jps.run(2 * k + 3, **QUIET)
    out = dict(npt_loop1=jps.loop, npt_L1=np.asarray(jps.Lv, np.float64))
    jps.run(2 * (k // 2), migrate_rate=k // 2, **QUIET)
    return dict(out, npt_loop2=jps.loop,
                npt_L2=np.asarray(jps.Lv, np.float64))


def _jax_by_gid(jps):
    m = np.asarray(jps.mask)
    g = np.asarray(jps.fields["gid"])[:, 0].astype(np.int64)[m]
    r = np.asarray(jps.fields["r"], np.float64)[m]
    out = np.zeros_like(r)
    out[g] = r
    return out


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """The spawn's results and, computed meanwhile in this process, the
    JAX references: its mesh's NVT and NPT runs, its Simulation's run of
    the outputs deck; then the port's Simulation on the same deck."""
    root = tmp_path_factory.mktemp("mesh_outputs")
    dirs = {k: str(root / k) for k in ("nvt", "npt", "hot_list",
                                       "hot_cells", "out", "jax", "mesh",
                                       "sim")}
    for d in dirs.values():
        os.makedirs(d)
    chip_smoke.water_deck(dirs["nvt"], 400, printrate=100, free=True)
    chip_smoke.edit_deck(
        chip_smoke.npt_water_deck(dirs["npt"], 400, printrate=100,
                                  free=True),
        lambda text: re.sub(r"updateRate=\d+;", f"updateRate={NPT_K};",
                            text))
    for engine, (sites, _, T) in HOT.items():
        _hot_deck(dirs[f"hot_{engine}"], T, sites)
    _outputs_deck(dirs["out"])
    decks = {"nvt": (dirs["nvt"], dict(R=NVT_R)),
             "npt": (dirs["npt"], {}),
             "hot_list": (dirs["hot_list"], dict(steps=HOT["list"][1],
                                                 R=HOT_R)),
             "hot_cells": (dirs["hot_cells"], dict(steps=HOT["cells"][1],
                                                   R=HOT_R, dtype="float32")),
             "outputs": (dirs["out"], dict(steps=OUT_STEPS,
                                           run_dir=dirs["mesh"]))}
    out = str(root / "legs.npz")
    join = ranks.start_ranks(ranks.mesh_outputs, 2, root, decks, out,
                             timeout=240.0)
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_jax_nvt, dirs["nvt"]),
                pool.submit(_jax_npt, dirs["npt"])]
        js = JSimulation(*j_load(dirs["out"]), run_dir=dirs["jax"],
                         dtype=jnp.float64, engine="nlist")
        js.run(OUT_STEPS, **QUIET)
        ts = TSimulation(*t_load(dirs["out"]), run_dir=dirs["sim"],
                         device="cpu", dtype=torch.float64, engine="nlist")
        ts.run(OUT_STEPS, **QUIET)
        ref = {k: v for job in jobs for k, v in job.result().items()}
    join()
    return dict(np.load(out)), ref, dirs


def test_nvt_migrate_rate_matches_jax_mesh(legs):
    """Per-step dispatch with a migration every NVT_R loops (JAX
    _run_per_step): positions by gid after 3 NVT_R steps equal the JAX
    mesh's (f64, FREE), to the periodic image (either mesh may wrap a
    row)."""
    z, ref, _ = legs
    assert int(z["nvt_loop"]) == ref["nvt_loop"] == 3 * NVT_R
    assert str(z["nvt_engine"]) == "nlist"
    d = z["nvt_r"] - ref["nvt_r"]
    box = chip_smoke.box_edge(legs[2]["nvt"]) / 10.0        # A -> nm
    d -= box * np.round(d / box)
    assert np.abs(d).max() <= 1e-10


def test_npt_migrate_rate_is_the_chunk_length(legs):
    """tests/test_brick.py:153-158's case on the Berendsen water deck
    (FREE, f64, updateRate k = NPT_K): 2 k + 3 loops, then 2 h more with
    migrate_rate = h = k / 2 (the chunk length under the barostat); the
    loop counts and the box equal the JAX mesh's after each run, and
    every particle is kept."""
    z, ref, _ = legs
    assert int(z["npt_loop1"]) == ref["npt_loop1"] == 2 * NPT_K + 3
    assert int(z["npt_loop2"]) == ref["npt_loop2"] == 3 * NPT_K + 3
    for key in ("npt_L1", "npt_L2"):
        np.testing.assert_allclose(z[key], ref[key], rtol=1e-10, atol=0)
    assert not np.allclose(z["npt_L2"], z["npt_L1"], rtol=1e-9, atol=0)
    assert int(z["npt_n"]) == 400


@pytest.mark.parametrize("engine", ["list", "cells"])
def test_hot_fluid_never_loses_a_pair(legs, engine):
    """The hot FREE fluid, one-step runs with migrate_rate = 2
    chunk_steps: rows sit outside their bricks before most steps, and
    every step's energy and forces equal the single-device list's on the
    same positions (the port's Simulation, engine "nlist", f64): 1e-10
    of the force scale in f64 on the list engine, where the drift guard
    flags and the host redistributes, 2e-5 in f32 on the cells engine,
    whose per-step rebuild bins every row where it lies (a dropped pair
    moves a force by ~1e-2 of it)."""
    z, _, dirs = legs
    leg = f"hot_{engine}"
    assert str(z[f"{leg}_engine"]) == {"list": "nlist",
                                       "cells": "pallas"}[engine]
    assert z[f"{leg}_outside"].max() > 0
    if engine == "list":
        assert len(z[f"{leg}_redis"]) >= 1
    sim = TSimulation(*t_load(dirs[leg]), run_dir=dirs[leg], device="cpu",
                      dtype=torch.float64, engine="nlist")
    tol = 1e-10 if engine == "list" else 2e-5
    n = sim.sysdef.state.n_local
    for i in range(HOT[engine][1]):
        st = sim.ss.state
        r = st.r.clone()
        r[:n] = torch.as_tensor(z[f"{leg}_r"][i])
        ss = sim._energy_at(sim.ss.replace(state=st.replace(r=r)))
        f_ref = ss.state.f[:n].numpy()
        scale = np.abs(f_ref).max()
        assert np.abs(z[f"{leg}_f"][i] - f_ref).max() <= tol * scale, i
        e_ref = float(ss.energy.eion)
        assert abs(z[f"{leg}_e"][i] - e_ref) <= tol * abs(e_ref), i


def _files(d):
    return chip_smoke.analysis_files(d)


def test_outputs_match_jax_simulation(legs):
    """The outputs deck's files after OUT_STEPS steps, the mesh's at
    (2,1,1) against the JAX Simulation's (chip_smoke.outputs_agree): the
    same files; every analysis file's numbers within AN_FLOAT_TOL of
    their column's largest magnitude (the chip script's masters_agree
    tolerance; SUBSETWRITE's positions to the periodic image), the
    stress and the group files too beyond their printed digits, VCMWRITE
    (zero to rounding in a FREE run) within 1e-12; stress.data not zero,
    its rows and the group files' at 20 and 40.  The graphs and vcm30
    (which the JAX run loop steps over) below."""
    z, _, dirs = legs
    assert str(z["outputs_engine"]) == "nlist"
    assert {"stress.data", "group_solvent.data", "group_half.data",
            "paircorrelation.dat", "cgrid", "vcm30.data"} <= set(
        _files(dirs["mesh"]))
    floats, exact, vcm, diff = chip_smoke.outputs_agree(
        dirs["mesh"], dirs["jax"], chip_smoke.box_edge(dirs["out"]),
        skip=("vcm30.data",))
    assert floats <= chip_smoke.AN_FLOAT_TOL, diff
    assert exact <= chip_smoke.AN_FLOAT_TOL and vcm <= 1e-12, diff
    st = chip_smoke.analysis_rows(os.path.join(dirs["mesh"], "stress.data"))
    assert st[:, 0].tolist() == [20, 40] and np.abs(st[:, 1:4]).min() > 0
    for g in ("solvent", "half"):
        rows = chip_smoke.analysis_rows(os.path.join(dirs["mesh"],
                                                     f"group_{g}.data"))
        assert rows[:, 0].tolist() == [20, 40]


def test_graphs_columns_and_nlocal(legs):
    """One graphs line a dispatch with Simulation's columns (the list
    engine's: loop, time, nlocal, steps) and the owned count of each
    brick appended; nlocal mesh-wide, equal to the JAX Simulation's."""
    _, _, dirs = legs

    def keys(line):
        return [t.split("=")[0] for t in line.split()[2:]]

    with open(os.path.join(dirs["jax"], "graphs")) as f:
        jl = f.read().splitlines()
    with open(os.path.join(dirs["mesh"], "graphs")) as f:
        ml = f.read().splitlines()
    assert jl and ml
    for line in ml:
        assert keys(line) == keys(jl[0]) + ["owned"]
        kv = dict(t.split("=") for t in line.split()[2:])
        owned = [int(x) for x in kv["owned"].split(",")]
        assert len(owned) == 2 and sum(owned) == int(kv["nlocal"]) == 400
    assert {dict(t.split("=") for t in ln.split()[2:])["nlocal"]
            for ln in jl} == {"400"}


def test_rate_the_cadence_steps_over(legs):
    """vcm30 (eval_rate 30, outputrate 60) on the 20-step cadence: the
    mesh's dispatches end on loop 30 as the port's Simulation's do
    (ROADMAP section 3: the JAX run loop steps over it), so both
    evaluate there and write the same row; every dispatch ended on each
    rate's multiple."""
    z, _, dirs = legs
    ends = z["outputs_ends"].tolist()
    assert {20, 30, 40} <= set(ends) and ends[-1] == OUT_STEPS
    rows = {w: chip_smoke.analysis_rows(os.path.join(dirs[w], "vcm30.data"))
            for w in ("mesh", "sim")}
    assert rows["mesh"][:, 0].tolist() == rows["sim"][:, 0].tolist() == [30]
    np.testing.assert_allclose(rows["mesh"], rows["sim"], rtol=1e-7,
                               atol=1e-12)


def test_cells_rebuild_guard():
    """BrickStepCells._rebuild_guard on a (3,1,1) plan: a row outside its
    brick on the axis of three bricks flags, one inside does not, and an
    axis of two bricks takes any excursion."""
    from types import SimpleNamespace

    from ddcmd_tpu_torch.parallel.brick import BrickPlan
    from ddcmd_tpu_torch.parallel.brickstep_cells import BrickStepCells

    def flag(shape, x):
        self = SimpleNamespace(
            plan=BrickPlan(shape=shape, local_cap=8, halo_cap=8,
                           migrate_cap=8, rlist=1.0),
            mesh=SimpleNamespace(idx3=(1, 0, 0)))
        r = torch.tensor([[x, 0.0, 0.0], [0.0, 0.0, 0.0]])
        mask = torch.tensor([True, True])
        return bool(BrickStepCells._rebuild_guard(
            self, {"r": r}, mask, torch.tensor([9.0, 9.0, 9.0])))

    # brick 1 of 3 on x spans [-1.5, 1.5)
    assert not flag((3, 1, 1), 1.4)
    assert flag((3, 1, 1), 1.6) and flag((3, 1, 1), -1.6)
    # brick 1 of 2 spans [0, 4.5)
    assert not flag((2, 1, 1), -2.0)


def test_npt_superchunk_takes_the_migrate_rate(tmp_path):
    """Under the barostat a superchunk is made of migrate_rate-long chunks
    (the JAX package's make_super of _chunk_for(migrate_rate)): the
    Berendsen water deck (FREE, f64) at (1,1,1), 2 NPT_K steps with
    migrate_rate NPT_K / 2 in one dispatch of four chunks and in four
    dispatches, the same loop and box (1e-12)."""
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    d = str(tmp_path)
    chip_smoke.edit_deck(
        chip_smoke.npt_water_deck(d, 400, printrate=100, free=True),
        lambda text: re.sub(r"updateRate=\d+;", f"updateRate={NPT_K};",
                            text))
    out = []
    for cap in (2 * NPT_K, None):
        ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu",
                                dtype=torch.float64)
        ps.run(2 * NPT_K, migrate_rate=NPT_K // 2,
               max_steps_per_dispatch=cap, **QUIET)
        out.append((ps.loop, ps.Lv.numpy().copy(),
                    [k for k, _ in ps.dispatch_log]))
    (l1, L1, d1), (l2, L2, d2) = out
    assert l1 == l2 == 2 * NPT_K
    assert d1 == [2 * NPT_K] and d2 == [NPT_K // 2] * 4
    np.testing.assert_allclose(L1, L2, rtol=1e-12, atol=0)
    assert not np.allclose(L1, chip_smoke.box_edge(d) / 10.0, rtol=1e-9,
                           atol=0)
