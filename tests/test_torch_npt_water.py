"""The reference deck's NPT water box (NGLFCONSTRAINT, T 310 K, P0 1 bar,
beta 3.0e-4/bar, tauBarostat 1 ps, BASELINE.md:14) in both drivers of
the port against the JAX package's Simulation, on martini_water(n=400).

One step with a FREE group (no thermostat noise) from the same state:
forces, energy, virial, the barostat's scale lambda and the box.  The
JAX side runs its cell-block engine in float64; the port's f32 pair term
is held to it at the tolerances of tests/test_pallas_cellpair.py (force
2e-5 of the scale, energy rel 1e-4) and lambda - 1 to rel 1e-4.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_water as j_martini_water
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load, martini_bilayer, martini_water
from ddcmd_tpu_torch.run import cli
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
from ddcmd_tpu_torch.run.simulate import Simulation

torch.set_num_threads(2)

NPT = ("type=NGLFCONSTRAINT; T=310.0K; P0=1.0 bar; beta=3.0e-4/bar; "
       "tauBarostat=1.0 ps;")


def _npt(s):
    return s.replace("type=NGLF; T=310.0K;", NPT)


def _free(s):
    return s.replace("type=LANGEVIN; Teq=310.0K; tau=1.0ps;", "type=FREE;")


def _decks(tmp_path, edits, n=400):
    out = []
    for name, build in (("jax", j_martini_water), ("torch", martini_water)):
        d = str(tmp_path / name)
        os.makedirs(d)
        build(d, n=n)
        p = os.path.join(d, "object.data")
        with open(p) as f:
            text = f.read()
        for fn in edits:
            new = fn(text)
            assert new != text
            text = new
        with open(p, "w") as f:
            f.write(text)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX Simulation after one step of the NPT deck (FREE group)."""
    tmp = tmp_path_factory.mktemp("npt")
    jd, td = _decks(tmp, (_npt, _free))
    js = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64,
                     engine="cellblock")
    assert js._barostat is not None
    L0 = np.asarray(js.ss.box.lengths)
    js.run(1, print_fn=lambda s: None)
    n = js.sysdef.state.n_local
    e = js.ss.energy
    return dict(td=td, n=n, L0=L0, L1=np.asarray(js.ss.box.lengths),
                f=np.asarray(js.ss.state.f[:n]), e=float(e.eion),
                virial=np.asarray(e.virial))


def _check(ref, L1, f, e, virial):
    np.testing.assert_allclose(L1 / ref["L0"] - 1.0,
                               ref["L1"] / ref["L0"] - 1.0, rtol=1e-4)
    np.testing.assert_allclose(L1, ref["L1"], rtol=1e-6)
    scale = float(np.abs(ref["f"]).max())
    assert np.abs(f - ref["f"]).max() <= 2e-5 * scale
    assert e == pytest.approx(ref["e"], rel=1e-4)
    vs = np.abs(ref["virial"]).max()
    np.testing.assert_allclose(virial, ref["virial"], rtol=1e-3,
                               atol=1e-4 * vs)


def test_one_step_simulate(reference):
    td = reference["td"]
    sim = Simulation(*load(td), run_dir=td, device="cpu")
    assert sim.engine == "kernel" and sim.barostat is not None
    assert sim.n_molecules == 400          # single-bead waters
    sim.run(1, print_fn=lambda s: None)
    n = reference["n"]
    e = sim.ss.energy
    _check(reference, sim.ss.box.lengths.double().numpy(),
           sim.ss.state.f[:n].double().numpy(), float(e.eion),
           e.virial.double().numpy())


def test_one_step_mesh(reference):
    """The mesh at (1,1,1): one NPT chunk of one step."""
    td = reference["td"]
    ps = ParallelSimulation(*load(td), shape=(1, 1, 1), device="cpu")
    assert ps.barostat is not None and ps.barostat["n_molecules"] == 400
    ps.first_energy()
    ps.run(1)
    assert ps.loop == 1
    # the chunk keeps only the virial diagonal; the forces come back by gid
    f = ps.gather_by_gid(("f",))["f"].astype(np.float64)
    L1 = ps.Lv.double().numpy()
    scale = float(np.abs(reference["f"]).max())
    np.testing.assert_allclose(L1 / reference["L0"] - 1.0,
                               reference["L1"] / reference["L0"] - 1.0,
                               rtol=1e-4)
    assert np.abs(f - reference["f"]).max() <= 2e-5 * scale
    np.testing.assert_allclose(ps.vird.double().numpy(),
                               np.diagonal(reference["virial"]), rtol=1e-3,
                               atol=1e-4 * np.abs(reference["virial"]).max())


def test_forty_steps_box_follows_jax(reference, tmp_path):
    """From the lattice start the box expands fast (the barostat moves it
    by ~7% in 40 steps at 20 fs); over 40 FREE steps the port's box
    follows the JAX Simulation's."""
    jd, td = _decks(tmp_path, (_npt, _free))
    js = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64,
                     engine="cellblock")
    js.run(40, print_fn=lambda s: None)
    sim = Simulation(*load(td), run_dir=td, device="cpu")
    sim.run(40, print_fn=lambda s: None)
    L0, L1 = reference["L0"], np.asarray(js.ss.box.lengths)
    assert (np.abs(L1 / L0 - 1.0) > 0.05).all()
    np.testing.assert_allclose(sim.ss.box.lengths.double().numpy(), L1,
                               rtol=1e-5)


def test_cli_npt_water_steps(tmp_path):
    """The reference deck as it is (LANGEVIN 310 K) through the CLI: 40
    steps, finite energies, the box within the 20% chip_smoke.py gates."""
    d = str(tmp_path)
    martini_water(d, n=400)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(_npt(text))
    sim = cli.run(["simulate", "-o", p, "-n", "40", "--run-dir", d,
                   "--device", "cpu"])
    L0 = sim.sysdef.box.lengths.numpy()
    L1 = sim.ss.box.lengths.numpy()
    assert sim.ss.loop == 40 and np.isfinite(float(sim.ss.energy.eion))
    assert (L1 != L0).all() and (np.abs(L1 / L0 - 1.0) < 0.2).all()


def test_mesh_refuses_nglfnew_with_constraints(tmp_path):
    """NGLFNEW with constraints, which the mesh refused while the JAX
    package has two rules (its mesh does not project, its Simulation
    does): the mesh now projects them as Simulation does
    (uses_constraints), through one chunk with the RATTLE residual of
    the NPT bilayer's constraints kept; Simulation projects, as the JAX
    Simulation."""
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual

    d = str(tmp_path)
    martini_bilayer(d, nx=4, ny=4, water_nm=1.2)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    new = text.replace("type=NGLFCONSTRAINT;", "type=NGLFNEW;")
    assert new != text
    with open(p, "w") as f:
        f.write(new)
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
    assert ps.sysdef.integrator_type == "NGLFNEW"
    assert ps.step_fn.cons_templates is not None
    ps.run(ps.chunk_steps)
    bt = ps.sysdef.bonded
    r = ps.gather_by_gid(("r",))["r"]
    assert ps.loop == ps.chunk_steps
    assert constraint_residual(SimpleNamespace(r=r), bt.cons_atoms,
                               bt.cons_pairs, bt.cons_dist,
                               box_lengths=ps.Lv.numpy()) < 5e-3
    sim = Simulation(*load(d), run_dir=d, device="cpu")
    assert sim.constraint_fn is not None
