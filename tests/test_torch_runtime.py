"""Slice 15, the run-time layer of Simulation (ROADMAP item 23): the
per-group energy files and the graphs line, NEXTFILE and NGLFTEST
against the JAX package's Simulation in f64 (the NaN rollback and the
attempt-keyed noise: test_torch_rollback.py; the command file:
test_torch_runtime_cmds.py).

Tolerances: group-file rows of one state rel 1e-12 (at the printed
resolution, 1e-8 absolute); after 20 f64 steps rel 1e-9; the graphs lines
equal; NEXTFILE energies rel 1e-10; the NGLFTEST histograms equal and
their printed medians equal.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.ops.pallas_cellpair import plan_lanes as j_plan_lanes
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.restart import write_checkpoint
from ddcmd_tpu_torch.models import lj_fluid, martini_water
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)
QUIET = dict(print_fn=lambda line: None)


def _edit(d, fn):
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    new = fn(text)
    assert new != text
    with open(p, "w") as f:
        f.write(new)


def _two_group_lj(tmp_path, n=500, groups="type=FREE;", graphs=True):
    """lj_fluid split at z = 0 into groups top and bot (each `groups`),
    printrate 10, printGraphs=1."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=n)
    chip_smoke.regroup(d, {"top": groups, "bot": groups},
                       lambda r: ["top" if z > 0 else "bot" for z in r[:, 2]],
                       printrate=10)
    if graphs:
        _edit(d, lambda t: t.replace("type=MD;", "type=MD; printinfo=pi;", 1)
              + "pi PRINTINFO { printGraphs=1; }\n")
    return d


def _rows(path):
    with open(path) as f:
        return np.array([[float(x) for x in ln.split()] for ln in f])


def _run_dirs(tmp_path):
    jd, td = str(tmp_path / "jrun"), str(tmp_path / "trun")
    os.makedirs(jd)
    os.makedirs(td)
    return jd, td


def test_group_files_of_one_state_match_jax(tmp_path):
    """The per-group rows (members, T, KE and PE a member) of the start
    state after the first energy, in f64 on the cell-block engines; the
    PE sums over the groups equal the total potential energy."""
    d = _two_group_lj(tmp_path, graphs=False)
    jd, td = _run_dirs(tmp_path)
    js = JSimulation(*j_load(d), run_dir=jd, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=td, device="cpu",
                     dtype=torch.float64)
    js.first_energy()
    ts.first_energy()
    js._emit_group_files()
    ts._emit_group_files()
    counts = []
    for g in ("top", "bot"):
        a = _rows(os.path.join(td, f"group_{g}.data"))
        b = _rows(os.path.join(jd, f"group_{g}.data"))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-8)
        counts.append(a[0, 1] * a[0, 4])
    assert sum(counts) == pytest.approx(float(ts.ss.energy.eion), rel=1e-6)


def test_group_files_and_graphs_after_a_run_match_jax(tmp_path,
                                                      monkeypatch):
    """20 f64 steps of the two-group FREE deck with printGraphs=1 (the
    JAX package at its fixed rebuild cadence, the port's): the graphs
    lines are equal and the group files' rows at printrate agree."""
    monkeypatch.setenv("DDCMD_FIXED_REBUILD", "1")
    d = _two_group_lj(tmp_path)
    jd, td = _run_dirs(tmp_path)
    js = JSimulation(*j_load(d), run_dir=jd, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=td, device="cpu",
                     dtype=torch.float64)
    assert ts.engine == js.engine == "cellblock"
    js.run(20, max_steps_per_dispatch=10, **QUIET)
    ts.run(20, max_steps_per_dispatch=10, **QUIET)
    with open(os.path.join(td, "graphs")) as f:
        tg = f.read().splitlines()
    with open(os.path.join(jd, "graphs")) as f:
        assert tg == f.read().splitlines()
    assert len(tg) == 2 and "pair_slots=" in tg[0]
    for g in ("top", "bot"):
        a = _rows(os.path.join(td, f"group_{g}.data"))
        assert a[:, 0].tolist() == [10, 20]
        np.testing.assert_allclose(
            a, _rows(os.path.join(jd, f"group_{g}.data")), rtol=1e-9,
            atol=1e-8)


def test_kernel_engine_graphs_line_is_the_jax_pallas_line(tmp_path):
    """The kernel engine's graphs line (plan_lanes, cells, cap, pair
    slots) equals the line the JAX package's _emit_graphs writes for its
    pallas engine's plan of the same box."""
    d = str(tmp_path / "w")
    os.makedirs(d)
    martini_water(d, n=1600)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu")
    assert ts.engine == "kernel"
    sd = ts.sysdef
    ts._emit_graphs(20)
    jgrid = j_plan_lanes(sd.box.lengths.numpy().astype(np.float64),
                         sd.rcut_max, sd.neighbor_deltaR, sd.state.n_local)
    stub = types.SimpleNamespace(
        grid=jgrid, run_dir=str(tmp_path),
        sysdef=types.SimpleNamespace(state=types.SimpleNamespace(
            n_local=sd.state.n_local)),
        ss=types.SimpleNamespace(loop=ts.ss.loop, time=ts.ss.time))
    JSimulation._emit_graphs(stub, 20)
    with open(os.path.join(d, "graphs")) as f:
        line = f.read()
    with open(tmp_path / "graphs") as f:
        assert line == f.read()
    assert f"pair_slots={ts.grid.ncell * 27 * ts.grid.cap ** 2} " in line


def _record_first_energies(sim):
    out = []
    orig = sim.first_energy

    def rec():
        ss = orig()
        out.append(float(ss.energy.eion))
        return ss

    sim.first_energy = rec
    return out


def test_nextfile_replays_snapshots_as_jax(tmp_path):
    """A NEXTFILE deck over three snapshots of an f64 LANGEVIN run: each
    file's energy equals the JAX package's replay (rel 1e-10) and the
    energy the run had at that loop (rel 1e-6: the files' precision)."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    files, at_loop = [], []
    for _ in range(3):
        sim.run(10, **QUIET)
        snap = write_checkpoint(sim, d, update_symlink=False)
        files.append(os.path.basename(snap) + "/atoms#")
        at_loop.append(float(sim.ss.energy.eion))
    _edit(d, lambda t: t.replace(
        "type=NGLF;", f"type=NEXTFILE; files={' '.join(files)};"))
    jd, td = _run_dirs(tmp_path)
    ts = TSimulation(*t_load(d), run_dir=td, device="cpu",
                     dtype=torch.float64)
    js = JSimulation(*j_load(d), run_dir=jd, dtype=jnp.float64)
    te, je = _record_first_energies(ts), _record_first_energies(js)
    lines = []
    ts.run(print_fn=lines.append)
    js.run(**QUIET)
    assert len(te) == len(je) == 3 and ts.ss.loop == 3
    np.testing.assert_allclose(te, je, rtol=1e-10)
    np.testing.assert_allclose(te, at_loop, rtol=1e-6)
    assert [ln.split(":")[0] for ln in lines] == [
        f"nextfile[{i}] {f}" for i, f in enumerate(files)]


def test_nglftest_histograms_match_jax(tmp_path):
    """NGLFTEST (subDivide 4) on a 300-atom LJ fluid in f64: SingleStep.dist
    and MultiStep.dist equal the JAX package's, the printed medians too,
    and the four substeps beat the one step."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300, integrator="NGLFTEST")
    _edit(d, lambda t: t.replace("type=NGLFTEST;",
                                 "type=NGLFTEST; subDivide=4;"))
    jd, td = _run_dirs(tmp_path)
    ts = TSimulation(*t_load(d), run_dir=td, device="cpu",
                     dtype=torch.float64)
    js = JSimulation(*j_load(d), run_dir=jd, dtype=jnp.float64)
    tl, jl = [], []
    ts.run(print_fn=tl.append)
    js.run(print_fn=jl.append)
    assert [ln.split()[:2] for ln in tl] == [ln.split()[:2] for ln in jl]
    for name in ("SingleStep.dist", "MultiStep.dist"):
        with open(os.path.join(td, name)) as f:
            a = f.read()
        with open(os.path.join(jd, name)) as f:
            assert a == f.read()
    meds = [float(ln.split("median=")[1].split()[0]) for ln in tl]
    assert meds[1] <= meds[0] < 1e-3
