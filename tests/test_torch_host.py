"""The port's host layer (deck parser, collection reader, builders,
build_system, Martini tables) against the JAX package, the port's
jax-free import and its device policy."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_water as j_martini_water
from ddcmd_tpu.potentials.martini import martini_device_tables as j_tables
import ddcmd_tpu_torch
from ddcmd_tpu_torch.core.system import build_system as t_build_system
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.models import martini_water as t_martini_water
from ddcmd_tpu_torch.potentials.martini import martini_device_tables as t_tables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decks(tmp_path, n=400, edit=None):
    """The same martini_water deck built by both packages' builders."""
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jd.mkdir()
    td.mkdir()
    j_martini_water(str(jd), n=n)
    t_martini_water(str(td), n=n)
    if edit is not None:
        for d in (jd, td):
            p = d / "object.data"
            p.write_text(edit(p.read_text()))
    return str(jd), str(td)


def _sim_key(text, keyword):
    """The deck with `keyword` added to its SIMULATE object."""
    new = text.replace("type=MD;", "type=MD; " + keyword, 1)
    assert new != text
    return new


def _tilted(text):
    """The deck's box with its b vector tilted by 0.1 L in x."""
    m = re.search(r"h= (\S+) 0 0 0 (\S+) 0 0 0 (\S+) ;", text)
    L = float(m.group(1))
    return text.replace(m.group(0), f"h= {L} {0.1 * L:.6f} 0 0 {L} 0 0 0 "
                        f"{L} ;")


def _printinfo(text, keyword):
    """The deck with a PRINTINFO object that sets `keyword`."""
    return (_sim_key(text, "printinfo=pinfo;")
            + "pinfo PRINTINFO { " + keyword + " }\n")


def test_builders_write_identical_decks(tmp_path):
    jd, td = _decks(tmp_path)
    for name in ("object.data", "martini.data", "atoms#000000"):
        with open(os.path.join(jd, name)) as a, \
                open(os.path.join(td, name)) as b:
            assert a.read() == b.read(), name


def test_deck_parses_to_same_objects(tmp_path):
    jd, td = _decks(tmp_path)
    jdb, _ = j_load(jd)
    tdb, _ = t_load(td)
    assert sorted(jdb.objects) == sorted(tdb.objects)
    for key, jo in jdb.objects.items():
        to = tdb.objects[key]
        assert (to.name, to.objclass, to.keywords) == \
            (jo.name, jo.objclass, jo.keywords)


def test_build_system_matches_jax(tmp_path):
    jd, td = _decks(tmp_path)
    jsd = j_build_system(j_load(jd)[0], jd)
    tsd = t_build_system(t_load(td)[0], td)
    js, ts = jsd.state, tsd.state
    assert ts.n_local == js.n_local and ts.n_pad == js.n_pad
    for name in ("r", "v", "f", "pe", "q", "mass", "species", "group"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(ts.gid[:ts.n_local], js.gid64())
    np.testing.assert_array_equal(ts.fmask.numpy(), np.asarray(js.fmask))
    np.testing.assert_array_equal(tsd.box.h.numpy(), np.asarray(jsd.box.h))
    assert tsd.box.pbc == jsd.box.pbc
    assert (tsd.neighbor_deltaR, tsd.rcut_max, tsd.integrator_type,
            tsd.random_seed, tsd.n_constraints) == \
        (jsd.neighbor_deltaR, jsd.rcut_max, jsd.integrator_type,
         jsd.random_seed, jsd.n_constraints)
    assert tsd.cfg.dt == jsd.cfg.dt
    assert tsd.cfg.ddc_update_rate == jsd.cfg.ddc_update_rate
    assert tsd.integrator_parms["T"] == jsd.integrator_parms["T"]

    half = 0.5 * jsd.cfg.dt
    for t in (0.0, 3.7):
        jc = jsd.group_table.coefficients(t, half)
        tc = tsd.group_table.coefficients(t, half)
        for a, b in zip(tc, jc[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jp, tp = jsd.potentials[0][2], tsd.potentials[0][2]
    np.testing.assert_array_equal(tp.species_lj_type, jp.species_lj_type)
    jtab, ttab = j_tables(jp), t_tables(tp)
    for k in ("sigma", "eps", "shift"):
        np.testing.assert_array_equal(ttab[k].numpy(), np.asarray(jtab[k]))
    for k in ("rcut2", "krf", "crf", "keR"):
        assert ttab[k] == float(jtab[k]), k


# two springs on the first rows (tests/test_torch_cellblock.py)
_RESTRAINT = """
rs POTENTIAL { type=RESTRAINT; }
rlist RESTRAINTLIST { restraintList=r0 r1; }
r0 RESTRAINTPARMS { gid=3; kb=50 kJ/mol/nm^2; x0=0.1 nm; y0=0.2 nm;
  z0=-0.3 nm; }
r1 RESTRAINTPARMS { gid=10; kb=80 kJ/mol/nm^2; x0=-0.5 nm; y0=0.0 nm;
  z0=0.4 nm; fcz=0; }
"""


# item 22's decks: Simulation runs them (test_item22_decks_run), and
# so does the mesh (tests/test_torch_mesh_dynamics.py holds it to
# Simulation)
_BERENDSEN = (lambda s: s.replace("type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
                                  "type=BERENDSEN; Teq=310.0K; tau=1.0ps;"))
_NPTGLF = (lambda s: s.replace("type=NGLF; T=310.0K;",
                               "type=NPTGLF; T=310.0K; Gamma=0.05 "
                               "amu/Angstrom^4; pressure=1 bar; zeta=0;"))
_DEFORMATION = (lambda s: s.replace(
    "pbc=7;", "pbc=7; deformationRate=0 0 0.01 0 0 0 0 0 0;"))


@pytest.mark.parametrize("edit,what", [
    # item 22's decks, which the mesh refused until it ran them as
    # Simulation does (`runs:` with no file: 20 steps under the mesh; the
    # ids keep the names these cases had when they were refusals): a
    # BERENDSEN Teq schedule, NPTGLF, an off-diagonal deformationRate --
    # 2 steps of it (`runs2:`), as test_item22_decks_run runs it: it tilts
    # the box by 0.2 L a step, past what a cell of this cutoff holds
    # within 20 (Simulation's cell-block plan runs out of memory there)
    pytest.param(lambda s: _BERENDSEN(s).replace(
        "Teq=310.0K; tau=1.0ps;", "Teq=RAMP(310,330,0,10ps); tau=1.0ps;"),
        "runs:", id="<lambda>-GROUP"),
    pytest.param(_NPTGLF, "runs:", id="<lambda>-integrator"),
    pytest.param(_DEFORMATION, "runs2:",
                 id=r"<lambda>-box\(t\).*item 22"),
    # outputs the JAX Simulation writes at their rates, which the mesh
    # refused until it wrote them too: these decks now run under the mesh
    # and write their files (`runs:`; the ids keep the names these cases
    # had when they were refusals)
    pytest.param(lambda s: _sim_key(s, "analysis=rdf;")
                 + "rdf ANALYSIS { type=PAIRCORRELATION; eval_rate=10; }\n",
                 "runs:paircorrelation.dat",
                 id=r"<lambda>-analysis=rdf.*item 24"),
    # Simulation applies transforms (tests/test_torch_transform_sim.py),
    # and so does the mesh since it applies them at their rates
    # (tests/test_torch_mesh_transforms.py; the JAX mesh applies none)
    pytest.param(lambda s: _sim_key(s, "transform=therm;")
                 + "therm TRANSFORM { type=THERMALIZE; rate=10; }\n",
                 "runs:",
                 id=r"<lambda>-transform=therm.*item 24"),
    pytest.param(lambda s: _printinfo(s, "printStress=1;"),
                 "runs:stress.data",
                 id=r"<lambda>-printStress.*item 24"),
    # the graphs line and the per-group energy files, which the JAX mesh
    # does not write (Simulation's: tests/test_torch_runtime.py)
    pytest.param(lambda s: _printinfo(s, "printGraphs=1;"),
                 "runs:graphs",
                 id=r"<lambda>-printGraphs.*item 23"),
    pytest.param(lambda s: s.replace("groups=solvent;",
                                     "groups=solvent frozen;")
                 + "frozen GROUP { type=FREE; }\n",
                 "runs:group_solvent.data",
                 id=r"<lambda>-per-group energy.*item 23"),
    # the list names only the ANALYSIS objects the deck has
    pytest.param(lambda s: _sim_key(s, "analysis=sw none;")
                 + "sw ANALYSIS { type=STRESSWRITE; eval_rate=10; }\n",
                 "runs:stress.data",
                 id=r"<lambda>-mesh:printStress.*item 24"),
    pytest.param(lambda s: _printinfo(s, "printStress=1; printGraphs=1;"),
                 "runs:stress.data graphs",
                 id=r"<lambda>-mesh:printStress+printGraphs.*item 25"),
    # what the mesh still refuses where Simulation runs the deck on its
    # cell-block engine: non-periodic axes (a triclinic box runs,
    # test_tilted_deck_runs_under_the_mesh)
    (lambda s: s.replace("pbc=7;", "pbc=3;"), r"mesh:pbc=3.*item 25"),
    # the mesh's potential selection: terms the JAX mesh drops silently
    # raise by name, as does a deck with no nonbond term
    (lambda s: s.replace("potential=martini;", "potential=martini rs;")
     + _RESTRAINT, r"mesh:RESTRAINT \(rs\) under the mesh.*item 25"),
    (lambda s: s.replace("potential=martini;", "potential=rs;")
     + _RESTRAINT, r"mesh:RESTRAINT \(rs\) under the mesh.*item 25"),
    (lambda s: s.replace("potential=martini;", "potential=martini wall;")
     + "wall POTENTIAL { type=REFLECT; }\n",
     r"mesh:REFLECT \(wall\) under the mesh.*item 25"),
    (lambda s: s.replace("potential=martini;", "potential=zero;")
     + "zero POTENTIAL { type=NONE; }\n",
     r"mesh:0 nonbond terms.*item 25"),
])
def test_unported_deck_features_raise(tmp_path, edit, what):
    """Deck features outside the slice raise NotImplementedError naming
    what is missing, never run a different model silently; a `mesh:`
    case goes through ParallelSimulation at (1,1,1) over gloo.  A
    `runs:` case is a deck the mesh refused until it wrote its outputs at
    their rates, ran item 22's dynamics or applied SIMULATE transform=
    at its rate: at printrate 10 it runs 20
    steps (`runsN:`: N) under the mesh at (1,1,1) over gloo and writes the
    named files (if any), each with a row past its header."""
    from ddcmd_tpu_torch.run.simulate import Simulation

    runs = re.match(r"runs(\d*):", what)
    if runs:
        _, td = _decks(tmp_path, edit=lambda s: edit(s).replace(
            "printrate=100;", "printrate=10;"))
        _mesh_writes(tmp_path, td, what[runs.end():].split(),
                     int(runs.group(1) or 20))
        return
    _, td = _decks(tmp_path, edit=edit)
    if not what.startswith("mesh:"):
        with pytest.raises(NotImplementedError, match=what):
            Simulation(t_load(td)[0], td, run_dir=td, device="cpu")
        return
    import torch.distributed as dist

    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(NotImplementedError, match=what[len("mesh:"):]):
            ParallelSimulation(t_load(td)[0], td, shape=(1, 1, 1),
                               device="cpu")
    finally:
        dist.destroy_process_group()


def _mesh_writes(tmp_path, td, files, steps=20):
    """The deck in td through ParallelSimulation at (1,1,1) over a gloo
    rank of one, `steps` steps into td: each of `files` there with a row
    past its header line."""
    import torch.distributed as dist

    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ps = ParallelSimulation(t_load(td)[0], td, shape=(1, 1, 1),
                                device="cpu", run_dir=td)
        ps.run(steps, print_fn=lambda line: None)
    finally:
        dist.destroy_process_group()
    assert ps.loop == steps
    for name in files:
        with open(os.path.join(td, name)) as f:
            rows = [ln for ln in f.read().splitlines()
                    if ln.strip() and not ln.startswith("#")]
        assert rows, name


def test_tilted_deck_runs_under_the_mesh(tmp_path):
    """The water deck in a triclinic box (_tilted), which the mesh refused
    until it took triclinic bricks: ParallelSimulation at (1,1,1) picks
    the list engine and its first energy equals Simulation's (cell-block
    engine) within the mesh's 2e-5."""
    import torch.distributed as dist

    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    _, td = _decks(tmp_path, edit=_tilted)
    sim = Simulation(t_load(td)[0], td, run_dir=td, device="cpu")
    sim.first_energy()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ps = ParallelSimulation(t_load(td)[0], td, shape=(1, 1, 1),
                                device="cpu")
        e = ps.first_energy()
    finally:
        dist.destroy_process_group()
    assert not ps.sysdef.box.ortho and ps.shard_engine == "nlist"
    assert e == pytest.approx(float(sim.ss.energy.eion), rel=2e-5)


@pytest.mark.parametrize("edit", [_BERENDSEN, _NPTGLF, _DEFORMATION],
                         ids=["BERENDSEN", "NPTGLF", "deformationRate"])
def test_item22_decks_run(tmp_path, edit):
    """Item 22's decks above run in Simulation too: a BERENDSEN
    group, NPTGLF, an off-diagonal deformationRate (a tilting box, so
    the cell-block engine); two steps, finite energies."""
    from ddcmd_tpu_torch.run.simulate import Simulation

    _, td = _decks(tmp_path, edit=edit)
    sim = Simulation(t_load(td)[0], td, run_dir=td, device="cpu")
    sd = sim.sysdef
    assert (sd.group_table.has_berendsen, sd.integrator_type,
            sd.box_time is not None) == {
        _BERENDSEN: (True, "NGLF", False),
        _NPTGLF: (False, "NPTGLF", False),
        _DEFORMATION: (False, "NGLF", True)}[edit]
    assert sim.engine == ("cellblock" if edit is _DEFORMATION else "kernel")
    h0 = sim.ss.box.h.clone()
    sim.run(2, print_fn=lambda line: None)
    assert np.isfinite(float(sim.ss.energy.eion) + float(sim.ss.energy.rk))
    assert torch.equal(sim.ss.box.h, h0) == (edit is _BERENDSEN)


def test_deck_without_outputs_builds(tmp_path):
    """The guard refuses only what a deck asks for: the plain water deck
    (one group, no analyses, no PRINTINFO flags) builds in both drivers."""
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    _, td = _decks(tmp_path)
    sim = Simulation(t_load(td)[0], td, run_dir=td, device="cpu")
    assert not sim.printinfo.print_stress and not sim.printinfo.print_graphs
    ps = ParallelSimulation(t_load(td)[0], td, shape=(1, 1, 1), device="cpu")
    assert len(ps.sysdef.groups) == 1


def test_tf32_pinned_off():
    assert ddcmd_tpu_torch.__name__ == "ddcmd_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


_NO_JAX_RUN = r"""
import importlib, json, pkgutil, sys
import ddcmd_tpu_torch
import ddcmd_tpu_torch.parallel
import ddcmd_tpu_torch.run.parallel_sim
from ddcmd_tpu_torch.models import martini_water
from ddcmd_tpu_torch.run import cli
for m in pkgutil.iter_modules(ddcmd_tpu_torch.parallel.__path__):
    importlib.import_module("ddcmd_tpu_torch.parallel." + m.name)
martini_water(sys.argv[1], n=400)
sim = cli.run(["simulate", "-o", sys.argv[1] + "/object.data", "-n", "5",
               "--run-dir", sys.argv[1], "--device", "cpu"])
print(json.dumps({"loop": sim.ss.loop,
                  "eion": float(sim.ss.energy.eion),
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.")
                                or m == "ddcmd_tpu"
                                or m.startswith("ddcmd_tpu."))}))
"""


def test_port_imports_no_jax(tmp_path):
    """`import ddcmd_tpu_torch`, every module of ddcmd_tpu_torch.parallel
    and run.parallel_sim, plus a 5-step CPU run, in a fresh interpreter,
    leave jax and the JAX package out of sys.modules."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _NO_JAX_RUN, str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == []
    assert res["loop"] == 5 and np.isfinite(res["eion"])


def test_mesh_refuses_restraint_beside_pair(tmp_path):
    """The deck of the mesh's selection fault: lj_fluid(n=500) with two
    RESTRAINT springs.  Simulation runs the springs; the mesh raises
    naming RESTRAINT and item 25 (the JAX mesh drops them and returns the
    energy of the deck without springs)."""
    import torch.distributed as dist

    from ddcmd_tpu_torch.models import lj_fluid
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    d = str(tmp_path / "lj")
    os.mkdir(d)
    lj_fluid(d, n=500)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    assert "potential=pot;" in text
    with open(p, "w") as f:
        f.write(text.replace("potential=pot;", "potential=pot rs;")
                + _RESTRAINT)
    sim = Simulation(*t_load(d), run_dir=d, device="cpu")
    assert [q[0] for q in sim.sysdef.potentials] == ["PAIR", "RESTRAINT"]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(NotImplementedError,
                           match=r"RESTRAINT \(rs\).*item 25"):
            ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def test_tabulated_function_equals_jax(tmp_path):
    """utils/tfunction.TabulatedFunction (host numpy, copied) reads a
    table file to the JAX package's arrays bit for bit: comments, an
    unsorted abscissa and a non-finite row dropped, resampled onto its
    grid, np.gradient derivatives."""
    from ddcmd_tpu.utils import tfunction as jtf
    from ddcmd_tpu_torch.utils import tfunction as ttf

    rng = np.random.default_rng(13)
    x = np.sort(rng.uniform(0.1, 0.6, 300))
    cols = np.stack([np.exp(-8.0 * x), 1.0 / x ** 4, np.sin(9.0 * x)], 1)
    rows = np.concatenate([x[:, None], cols], 1)[rng.permutation(300)]
    path = tmp_path / "tab.dat"
    with open(path, "w") as f:
        f.write("# r  phi  rho  extra\n")
        for i, row in enumerate(rows):
            f.write(" ".join("%.17g" % v for v in row)
                    + (" // a comment\n" if i == 7 else "\n"))
        f.write("0.3 inf 1 2\n")
    for n_grid in (2048, 97):
        j = jtf.TabulatedFunction.from_file(str(path), n_grid)
        t = ttf.TabulatedFunction.from_file(str(path), n_grid)
        assert (t.x0, t.dx, t.x_max) == (j.x0, j.dx, j.x_max)
        np.testing.assert_array_equal(t.values, j.values)
        np.testing.assert_array_equal(t.derivs, j.derivs)


def test_thermalize_copy_equals_jax():
    """transforms/thermalize.thermalize_velocities (host numpy, copied)
    draws the JAX package's velocities bit for bit, with and without the
    centre-of-mass removal."""
    from ddcmd_tpu.transforms import thermalize as jth
    from ddcmd_tpu_torch.transforms import thermalize as tth

    mass = np.random.default_rng(3).uniform(1.0, 80.0, 257)
    for remove in (True, False):
        a = tth.thermalize_velocities(mass, 310.0, seed=385212586,
                                      remove_vcm=remove)
        b = jth.thermalize_velocities(mass, 310.0, seed=385212586,
                                      remove_vcm=remove)
        assert np.array_equal(a, b)


def test_transform_registry_copy_equals_jax():
    """transforms/registry.py is the JAX package's registry (numpy only,
    copied): the same code statement for statement once the module
    docstring and the reference's source paths are set aside (the 16
    transforms' results: tests/test_torch_transforms.py)."""
    import ast

    from ddcmd_tpu.transforms import registry as jreg
    from ddcmd_tpu_torch.transforms import registry as treg

    def body(mod, text_of=lambda s: s):
        with open(mod.__file__) as f:
            tree = ast.parse(text_of(f.read()))
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(treg) == body(
        jreg, lambda s: s.replace("/root/reference/src/", "ddcMD src/"))


def test_loadbalance_copy_equals_jax():
    """parallel/loadbalance.py is the JAX package's balancer (host numpy,
    copied): the same code statement for statement once the docstrings
    are set aside (its results: tests/test_torch_loadbalance.py)."""
    import ast

    from ddcmd_tpu.parallel import loadbalance as jlb
    from ddcmd_tpu_torch.parallel import loadbalance as tlb

    def body(mod):
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.ClassDef)) and node.body and \
                    isinstance(node.body[0], ast.Expr) and \
                    isinstance(node.body[0].value, ast.Constant):
                node.body = node.body[1:]
        return ast.dump(tree)

    assert body(tlb) == body(jlb)


def test_voronoi_copy_equals_jax():
    """The host half of parallel/voronoi.py (OFFSETS, SELF_IDX,
    nominal_centers, beta_max, face_margins, clamp_centers, balance_step,
    assign_host and their helper) is the JAX package's numpy, copied:
    the same code statement for statement once the docstrings are set
    aside (its results: tests/test_torch_mesh_voronoi.py).  The device
    half (neighborhood_centers, dest_offsets) is torch and differs."""
    import ast

    from ddcmd_tpu.parallel import voronoi as jvor
    from ddcmd_tpu_torch.parallel import voronoi as tvor

    host = {"OFFSETS", "SELF_IDX", "nominal_centers", "beta_max",
            "_wrap_delta", "face_margins", "clamp_centers", "balance_step",
            "assign_host"}

    def body(mod):
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        out = {}
        for node in tree.body:
            name = (node.name if isinstance(node, ast.FunctionDef) else
                    node.targets[0].id if isinstance(node, ast.Assign)
                    else None)
            if name not in host:
                continue
            if isinstance(node, ast.FunctionDef) and node.body and \
                    isinstance(node.body[0], ast.Expr) and \
                    isinstance(node.body[0].value, ast.Constant):
                node.body = node.body[1:]
            out[name] = ast.dump(node)
        return out

    t, j = body(tvor), body(jvor)
    assert set(t) == host and t == j
