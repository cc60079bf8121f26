"""The port's brick-mesh run (run/parallel_sim.ParallelSimulation over
parallel/brickstep_cells) against the JAX package's single-device runs.

In-process at (1,1,1), and over gloo in spawned ranks (tests/
torch_mesh_ranks.py, which imports torch and the port only) at (2,2,1),
(2,2,2) and (2,1,1).  The JAX references are computed here, in the
parent.  Forces are compared with the JAX package's single-device
(N,K)-list evaluation in float64: on these lattice-start frames the f32
single-device evaluations of the two packages already differ from each
other by ~1e-5 of the force scale, so the f64 forces are the reference
the mesh's f32 forces are held to, at the tolerances of
tests/test_pallas_shard.py (LJ 2e-5, EAM 5e-5 of the scale; energy rel
2e-5).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import eam_crystal, load, martini_water
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

import torch_mesh_ranks as ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def water_deck(tmp_path_factory):
    """A water box whose (2,2,2) bricks clear 2 rlist (6.1 nm edge)."""
    d = str(tmp_path_factory.mktemp("water1700"))
    martini_water(d, n=1700)
    return d


@pytest.fixture(scope="module")
def crystal_deck(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cu8"))
    eam_crystal(d, nc=8)
    return d


def _jax_ref(d, dtype=jnp.float64):
    """(e, f (n, 3) in collection order, virial) of the JAX package's
    single-device (N,K)-list first energy."""
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist", dtype=dtype)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    e = sim.ss.energy
    return (float(e.eion), np.asarray(sim.ss.state.f[:n], np.float64),
            np.asarray(e.virial, np.float64))


def _assert_forces(f, f_ref, tol):
    scale = max(1.0, float(np.abs(f_ref).max()))
    err = float(np.abs(f - f_ref).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("system", ["water", "eam"])
def test_single_brick_mesh_matches_jax(tmp_path, system):
    """(1,1,1) in-process on the CPU: first energy and forces gathered by
    gid match the JAX package's single-device evaluation; one chunk plus
    migration keeps every particle and finite scalars."""
    d = str(tmp_path)
    if system == "water":
        martini_water(d, n=400)
        tol = 2e-5
    else:
        eam_crystal(d, nc=4)
        tol = 5e-5
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
    assert ps.force_kind == ("eam" if system == "eam" else "martini")
    assert ps.cplan.n_slot == ps.cplan.n_prog + 1       # no halo cells
    e = ps.first_energy()
    e_ref, f_ref, _ = _jax_ref(d)
    assert e == pytest.approx(e_ref, rel=2e-5)
    _assert_forces(ps.gather_by_gid(("f",))["f"], f_ref, tol)
    n = ps.sysdef.state.n_local
    ps.run(ps.chunk_steps)
    assert ps.loop == ps.chunk_steps and int(ps.mask.sum()) == n
    assert torch.isfinite(ps.f[ps.mask]).all()


def test_halo_invariants_four_ranks(tmp_path, water_deck):
    """(2,2,1) over 4 gloo ranks: the per-step refresh along the frozen
    routing rebuilds the exchange's ghost positions exactly, and the
    reverse reduce hands back exactly as many units as there are valid
    ghost rows, none on an empty row."""
    out = str(tmp_path / "halo")
    ranks.run_ranks(ranks.halo_invariants, 4, tmp_path, water_deck,
                    (2, 2, 1), out)
    res = [np.load(f"{out}_{r}.npz") for r in range(4)]
    assert not any(bool(z["ov"]) for z in res)
    assert all(float(z["same"]) == 0.0 for z in res)
    n_ghost = sum(int(z["n_ghost"]) for z in res)
    assert n_ghost > 0
    assert sum(float(z["copies"].sum()) for z in res) == n_ghost
    for z in res:
        assert (z["copies"][~z["mask"]] == 0).all()


@pytest.mark.parametrize("system", ["water", "eam"])
def test_eight_rank_first_forces_match_jax(tmp_path, system, water_deck,
                                           crystal_deck):
    """(2,2,2) over 8 gloo ranks: first forces, energy and virial of the
    water box (LJ, no Coulomb) and of the nc = 8 crystal (RATIONAL EAM)
    against the JAX package's single-device evaluation."""
    d, tol = ((water_deck, 2e-5) if system == "water"
              else (crystal_deck, 5e-5))
    out = str(tmp_path / "ff.npz")
    ranks.run_ranks(ranks.first_forces, 8, tmp_path, d, (2, 2, 2), out)
    z = np.load(out)
    assert not bool(z["ov"])
    e_ref, f_ref, v_ref = _jax_ref(d)
    assert float(z["e"]) == pytest.approx(e_ref, rel=2e-5)
    _assert_forces(z["f"], f_ref, tol)
    v_tol = (dict(rel=1e-3, abs=1.0) if system == "water"
             else dict(rel=5e-3, abs=1.0))
    assert z["virial"] == pytest.approx(v_ref, **v_tol)


def test_two_brick_axis_chunks_migrate(tmp_path, water_deck):
    """(2,1,1) over 2 gloo ranks, where both windows of every exchange go
    to the one neighbour: four chunks with migration keep every particle,
    move some across the brick faces, and stay finite."""
    out = str(tmp_path / "mig.npz")
    ranks.run_ranks(ranks.chunk_migrate, 2, tmp_path, water_deck,
                    (2, 1, 1), out)
    z = np.load(out)
    assert int(z["n"]) == 1700 and int(z["loop"]) == 80
    gids0, gids1 = z["gids0"], z["gids1"]
    assert len(np.unique(gids0)) == len(gids0) == 1700
    assert len(np.unique(gids1)) == len(gids1)
    np.testing.assert_array_equal(np.sort(gids1), np.sort(gids0))
    assert int(z["moved"]) > 0
    assert bool(z["finite"])


def test_device_defaults_to_cuda(tmp_path, monkeypatch):
    """Without a device argument the entry points take the CUDA card and
    raise when there is none; the CPU runs only when asked for."""
    from ddcmd_tpu_torch.run import cli
    from ddcmd_tpu_torch.run.simulate import Simulation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    martini_water(d, n=400)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Simulation(*load(d), run_dir=d)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ParallelSimulation(*load(d), shape=(1, 1, 1))
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.run(["simulate", "-o", os.path.join(d, "object.data"), "-n", "1",
                 "--run-dir", d])
    ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")


@pytest.mark.parametrize("edit,what", [
    (lambda s: s.replace("ddc DDC { updateRate=20; }",
                         "ddc DDC { updateRate=20; loadBalance=lb; }\n"
                         "lb LOADBALANCE { type=VORONOI; }"), "load balance"),
    (lambda s: s.replace("type=NGLF; T=310.0K;",
                         "type=NGLFCONSTRAINT; T=310.0K; beta=1e-5; "
                         "tauBarostat=1ps;"), "barostat"),
], ids=["edit0-load balance", "edit1-barostat"])
def test_unported_mesh_features_raise(tmp_path, edit, what):
    """Both deck features once refused here now build.  VORONOI load
    balance takes the brick list engine; at (1,1,1) its first energy and
    forces match the JAX package's f64 Simulation (energy 2e-5
    relative, forces 2e-5 of the scale) and it runs a chunk (the (2,2,2)
    domains: tests/test_torch_mesh_voronoi.py).  The barostat, refused
    before the NPT chunk was ported, carries into the mesh step."""
    d = str(tmp_path)
    martini_water(d, n=400)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    new = edit(text)
    assert new != text
    with open(p, "w") as f:
        f.write(new)
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
    if what == "barostat":
        assert ps.barostat is not None and ps.step_fn.barostat is not None
        assert ps.barostat["n_molecules"] == 400      # single-bead waters
        return
    assert ps.shard_engine == "nlist" and ps.plan.voronoi is not None
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    f0 = np.asarray(sim.ss.state.f[:400], np.float64)
    e = ps.first_energy()
    assert e == pytest.approx(float(sim.ss.energy.eion), rel=2e-5)
    f = ps.gather_by_gid(("f",))["f"]
    assert np.abs(f - f0).max() <= 2e-5 * np.abs(f0).max()
    ps.run(ps.chunk_steps)
    assert int(ps.mask.sum()) == 400 and torch.isfinite(ps.f).all()
