"""Top-level masters beyond simulate (reference masterFactory, ddcMD
src/masterFactory.c:23-122, masters.c).

Counterpart of ddcmd_tpu/run/masters.py: thermalize, readWrite,
eightFold, integrationTest and unitTest.  Each builds a Simulation on
`device` (the CUDA card by default; raises without one) in `dtype`.  The
analysis and transform masters need the registries of ROADMAP item 24
and raise naming it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..objects import DeckError, ObjectDB
from .simulate import Simulation


def analysis_master(*args, **kwargs):
    """analysisMaster (masters.c:85-99): the analysis registry is item
    24's."""
    raise NotImplementedError(
        "the analysis master needs the analyses, not ported yet (ROADMAP "
        "queue 1, item 24)")


def transform_master(*args, **kwargs):
    """transformMaster (masters.c:58-70): the transform registry is item
    24's."""
    raise NotImplementedError(
        "the transform master needs the transforms, not ported yet "
        "(ROADMAP queue 1, item 24)")


def thermalize_master(db: ObjectDB, base_dir=".", run_dir=".", *,
                      device=None, dtype=torch.float32, temperature=None):
    """thermalizeMaster (masterFactory.c:78): Maxwell-Boltzmann velocities
    at the integrator's T (or `temperature`), drawn on the host from the
    deck's seed (transforms/thermalize.py), then a checkpoint."""
    from ..io.restart import write_checkpoint
    from ..transforms.thermalize import thermalize_velocities

    sim = Simulation(db, base_dir, run_dir=run_dir, device=device,
                     dtype=dtype)
    sd = sim.sysdef
    T = temperature if temperature is not None else sd.integrator_parms["T"]
    n = sd.state.n_local
    mass = sd.state.mass[:n].cpu().numpy().astype(np.float64)
    v = thermalize_velocities(mass, T, seed=sd.random_seed or 385212586)
    vp = np.zeros((sd.state.n_pad, 3))
    vp[:n] = v
    sim.ss = sim.ss.replace(state=sim.ss.state.replace(
        v=torch.as_tensor(vp, dtype=dtype, device=sim.device)))
    snap = write_checkpoint(sim, run_dir)
    print(f"thermalizeMaster: T={T}K -> {snap}")
    return sim


def read_write_master(db: ObjectDB, base_dir=".", run_dir=".", *,
                      device=None, dtype=torch.float32):
    """readWriteMaster (masterFactory.c:71): read the collection and write
    it back out as a checkpoint (format conversion, validation)."""
    from ..io.restart import write_checkpoint

    sim = Simulation(db, base_dir, run_dir=run_dir, device=device,
                     dtype=dtype)
    snap = write_checkpoint(sim, run_dir)
    print(f"readWriteMaster: {sim.sysdef.state.n_local} particles -> {snap}")
    return sim


def eightfold_master(db: ObjectDB, base_dir=".", run_dir=".", *,
                     device=None, dtype=torch.float32):
    """eightFoldMaster (masterFactory.c:64): the system replicated 2x2x2
    into a doubled box, written as snapshot.8fold/atoms#000000 with a
    restart file that loads it (gids offset per copy)."""
    from ..io.collection import write_collection

    sim = Simulation(db, base_dir, run_dir=run_dir, device=device,
                     dtype=dtype)
    sd = sim.sysdef
    n = sd.state.n_local

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    r = host(sim.ss.state.r[:n])
    v = host(sim.ss.state.v[:n])
    h = host(sim.ss.box.h)
    L = np.diagonal(h)
    col = sd.collection
    rs, vs, gids, sp, gr, cl = [], [], [], [], [], []
    gid_stride = int(col.gid.max()) + 1
    copy = 0
    for ix in (0, 1):
        for iy in (0, 1):
            for iz in (0, 1):
                shift = (np.array([ix, iy, iz]) - 0.5) * L
                rs.append(r + shift)
                vs.append(v)
                gids.append(col.gid + copy * gid_stride)
                sp += col.species_names
                gr += col.group_names
                cl += col.class_names
                copy += 1
    outdir = os.path.join(run_dir, "snapshot.8fold")
    os.makedirs(outdir, exist_ok=True)
    write_collection(
        os.path.join(outdir, "atoms#000000"),
        gid=np.concatenate(gids), species_names=sp, group_names=gr,
        class_names=cl, r=np.concatenate(rs),
        v=np.concatenate(vs), h=h * 2, loop=0, time_fs=0.0,
        group_list=[g.name for g in sd.groups],
        species_list=[s.name for s in sd.species])
    hang = h * 2 * 10.0
    hstr = "\n".join("     %22.14g %22.14g %22.14g" % tuple(row)
                     for row in hang)
    with open(os.path.join(outdir, "restart"), "w") as f:
        f.write("simulate SIMULATE { loop=0; time=0.0 ;}\n")
        f.write(f"box BOX {{\nh={hstr} ;\n}}\n")
        f.write(f"collection COLLECTION {{ mode=VARRECORDASCII; size={8 * n};"
                f" files=snapshot.8fold/atoms#;}}\n")
    print(f"eightFoldMaster: {n} -> {8 * n} particles in {outdir}")
    return sim


def integration_test_master(db: ObjectDB, base_dir=".", run_dir=".", *,
                            device=None, dtype=torch.float64, rtol=1e-3):
    """integrationTestMaster (masters.c:204-249, integrationTest.c:35-238):
    for each INTEGRATIONTEST object's testPotentialPotential pairs,
    evaluate the two potentials alone on the same state on the list
    engine and compare their forces elementwise at rtol (of the first's
    largest force); raises AssertionError naming the pairs that
    differ.  Returns the Simulation and [(a, b, max rel err)]."""
    from ..core.system import plan_grid
    from ..nbr.celllist import build_neighbor_list

    tests = db.by_class("INTEGRATIONTEST")
    if not tests:
        raise DeckError("no INTEGRATIONTEST object in deck")
    sim = Simulation(db, base_dir, run_dir=run_dir, device=device,
                     dtype=dtype, engine="nlist")
    sd = sim.sysdef
    grid = plan_grid(sd)
    state, box = sd.state, sd.box
    nbr, _, ov = build_neighbor_list(state.r, state.fmask, box.geom, grid,
                                     pbc=box.pbc)
    if bool(ov):
        raise RuntimeError("neighbor overflow in integrationTest")
    results, failures = [], []
    for t in tests:
        pairs = t.get_strv("testPotentialPotential")
        for a_name, b_name in zip(pairs[::2], pairs[1::2]):
            fa = _single_potential_forces(sim, a_name, grid, nbr, dtype)
            fb = _single_potential_forces(sim, b_name, grid, nbr, dtype)
            err = np.abs(fa - fb).max() / max(np.abs(fa).max(), 1e-12)
            ok = err < rtol
            print(f"integrationTest {a_name} vs {b_name}: max rel err "
                  f"{err:.2e} {'PASS' if ok else 'FAIL'}")
            results.append((a_name, b_name, float(err)))
            if not ok:
                failures.append((a_name, b_name, err))
    if failures:
        raise AssertionError(f"integration test failures: {failures}")
    return sim, results


def _single_potential_forces(sim, pot_name, grid, nbr, dtype):
    """The forces of the deck's potential `pot_name` alone on sim's
    starting state, (n_pad, 3) f64 on the host."""
    import dataclasses

    from .forces import build_force_fn

    sd = sim.sysdef
    keep = [p for p in sd.potentials if p[1] == pot_name]
    if not keep:
        raise DeckError(f"integrationTest: potential {pot_name} not in "
                        "SYSTEM")
    sub = dataclasses.replace(sd, potentials=keep)
    f = build_force_fn(sub, grid, dtype, "nlist")(sd.state, sd.box, nbr)[0]
    return f.cpu().numpy().astype(np.float64)


def unit_test_master(tier: str = "fast") -> int:
    """unitTestMaster: the reference's CuTest tier is stubbed in its open
    release (nullRoutines.c:7); the port's is its own pytest suite,
    tests/test_torch_*.py, with -m "not slow" unless tier="full" (or
    DDCMD_UNITTEST_TIER=full).  Returns pytest's exit code."""
    import glob
    import subprocess
    import sys

    tier = os.environ.get("DDCMD_UNITTEST_TIER", tier)
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "tests")
    cmd = [sys.executable, "-m", "pytest",
           *sorted(glob.glob(os.path.join(tests, "test_torch_*.py"))), "-q"]
    if tier != "full":
        cmd += ["-m", "not slow"]
    return subprocess.call(cmd)
