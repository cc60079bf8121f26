"""The NPT chunk of the port's brick mesh on a small Martini bilayer
(nx = 4, 528 beads, one (1,1,1) brick on the CPU): the generic
constraint path against the template one, the host's rollback of a
flagged dispatch (box and virial diagonal included), and an exclusion
graph wider than the in-kernel encoding on the brick list engine."""

from types import SimpleNamespace

import pytest
import torch

from ddcmd_tpu_torch.models import load, martini_bilayer
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_deck(tmp_path_factory):
    """The 528-bead bilayer (nx = 4): one (1,1,1) brick, fast on the CPU."""
    d = str(tmp_path_factory.mktemp("bilayer4"))
    martini_bilayer(d, nx=4, ny=4, water_nm=1.2)
    return d


def test_generic_rattle_matches_templates(small_deck, monkeypatch):
    """The generic constraint path (gid-keyed groups, taken when a
    topology is not template-regular) forced on the bilayer: one NPT
    chunk from the same state lands where the template path does, and
    holds the constraints."""
    from ddcmd_tpu_torch.integrators import constraints
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual

    pt = ParallelSimulation(*load(small_deck), shape=(1, 1, 1), device="cpu")
    monkeypatch.setattr(constraints, "build_constraint_templates",
                        lambda *a, **kw: None)
    pg = ParallelSimulation(*load(small_deck), shape=(1, 1, 1), device="cpu")
    assert pt.step_fn.cons_templates is not None
    assert pg.step_fn.cons_templates is None
    assert pg.step_fn.cons_tables is not None
    outs = []
    for ps in (pt, pg):
        ps.first_energy()
        outs.append(ps.step_fn.chunk(ps.fields, ps.mask, ps.f,
                                     ps.box_state(), 0))
    (ft, mt, _, dt_, _, ovt), (fg, mg, _, dg, _, ovg) = outs
    Lt, Lg = dt_["Lv"], dg["Lv"]
    assert not bool(ovt) and not bool(ovg) and torch.equal(mt, mg)
    torch.testing.assert_close(Lg, Lt, rtol=1e-6, atol=0)
    for k in ("r", "v"):
        torch.testing.assert_close(fg[k][mg], ft[k][mt], rtol=0, atol=1e-6)
    bt = pg.sysdef.bonded
    r = pg.gather_by_gid(("r",))["r"]
    assert constraint_residual(SimpleNamespace(r=r), bt.cons_atoms,
                               bt.cons_pairs, bt.cons_dist,
                               box_lengths=Lg.numpy()) < 5e-3


def test_npt_overflow_rolls_back_box_and_redistributes(small_deck,
                                                       monkeypatch):
    """An overflowing NPT dispatch is discarded whole, the live box and
    virial diagonal included; the run redistributes and redoes it, and
    ends at the requested loop with every particle."""
    ps = ParallelSimulation(*load(small_deck), shape=(1, 1, 1), device="cpu")
    ps.first_energy()
    L0 = ps.Lv.clone()
    st = ps.step_fn
    real = st.chunk
    seen = []

    def once(*a, **kw):
        out = real(*a, **kw)
        seen.append(a[3]["Lv"].clone())         # the box the chunk began at
        return (*out[:-1], out[-1] | torch.tensor(len(seen) == 1))

    monkeypatch.setattr(st, "chunk", once)
    redis = []
    monkeypatch.setattr(ps, "redistribute", lambda: redis.append(1)
                        or ParallelSimulation.redistribute(ps))
    ps.run(ps.chunk_steps)
    assert len(seen) == 2 and redis == [1]
    assert torch.equal(seen[0], L0) and torch.equal(seen[1], L0)
    assert ps.loop == ps.chunk_steps and not torch.equal(ps.Lv, L0)
    assert int(ps.mask.sum()) == ps.sysdef.state.n_local


def test_wide_exclusion_component_raises(tmp_path, monkeypatch):
    """An exclusion component wider than the in-kernel channels encode
    (here wider than 4, patched) no longer raises: the engine pick sends
    the deck to the brick list engine, which masks the excluded pairs by
    gid.  In f64 its first energy and forces match the JAX package's f64
    Simulation on its list engine (1e-10 relative, 1e-10 of the force
    scale); in f32 it runs an NPT chunk keeping every bead."""
    import numpy as np

    import jax.numpy as jnp

    from ddcmd_tpu.models import load as j_load
    from ddcmd_tpu.run.simulate import Simulation as JSimulation
    from ddcmd_tpu_torch.run import forces

    d = str(tmp_path)
    martini_bilayer(d, nx=2, ny=2, water_nm=1.2)
    monkeypatch.setattr(forces, "EXCL_MAX_MEMBERS", 4)
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    f0 = np.asarray(sim.ss.state.f[:n], np.float64)
    e0 = float(sim.ss.energy.eion)
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu",
                            dtype=torch.float64)
    assert ps.shard_engine == "nlist" and ps._wide > 4
    assert ps._excl_vals is None and "exgid" in ps.fields
    e = ps.first_energy()
    assert abs(e - e0) <= 1e-10 * abs(e0)
    f = ps.gather_by_gid(("f",))["f"]
    assert np.abs(f - f0).max() <= 1e-10 * np.abs(f0).max()
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
    assert ps.barostat is not None and ps.shard_engine == "nlist"
    ps.run(ps.chunk_steps)
    assert ps.loop == ps.chunk_steps and int(ps.mask.sum()) == n
    assert torch.isfinite(ps.f[ps.mask]).all()
