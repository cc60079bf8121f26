"""The mesh's two engines against each other and the engine pick, and the
per-term gid resolver, against the JAX package.

parallel/bonded_shard.resolve_terms (and bonded_gid_tables) against the
JAX package's on the same pool; the cells engine (#6's plain version)
and the brick list engine (parallel/brickstep.BrickStepList, forced by
DDCMD_SHARD_ENGINE=nlist) on the water box at (2,2,2) over gloo ranks,
each against the JAX package's f64 Simulation; a forced pallas on a
deck the cells engine cannot take raises ValueError.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.potentials.bonded import BondedTerms as JBondedTerms

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

SHAPE = (2, 2, 2)


def test_resolve_terms_equal_jax():
    """bonded_shard.resolve_terms (and bonded_gid_tables) against the JAX
    package's on the same pool: a shuffled pool of local rows, ghosts
    (one gid twice, as a periodic image) and masked rows; every family,
    CMAP anchored at its slot 1."""
    import ddcmd_tpu.parallel.bonded_shard as jbs
    import ddcmd_tpu_torch.parallel.bonded_shard as tbs
    from ddcmd_tpu_torch.potentials.bonded import BondedTerms

    rng = np.random.default_rng(5)
    n = 40
    gid = (np.arange(n, dtype=np.int64) * 7 + (3 << 33))
    fams = dict(bonds=2, angles=3, torsions=4, impropers=4, bpairs=2,
                exclusions=2, cmap_atoms=5)
    bt_kw = {k: rng.integers(0, n, (11, a)).astype(np.int32)
             for k, a in fams.items()}
    dtab = {k: torch.as_tensor(v) for k, v in bt_kw.items()}
    dtab["bond_parms"] = torch.ones((11, 2))
    ttab = tbs.bonded_gid_tables(BondedTerms(**bt_kw), gid, dtab)
    jtab = jbs.bonded_gid_tables(
        JBondedTerms(**bt_kw), gid,
        {k: jnp.asarray(v.numpy()) for k, v in dtab.items()})
    for k in fams:
        np.testing.assert_array_equal(ttab[k + "_gids"].numpy(),
                                      np.asarray(jtab[k + "_gids"]))
    local_cap = 16
    pool = np.concatenate([rng.permutation(gid)[:30], gid[:4]])
    mask = np.ones(len(pool), bool)
    mask[[5, 20, 31]] = False
    tres = tbs.resolve_terms(ttab, torch.as_tensor(pool),
                             torch.as_tensor(mask), local_cap)
    jres = jbs.resolve_terms(jtab, jnp.asarray(pool), jnp.asarray(mask),
                             local_cap)
    owned = 0
    for k in fams:
        w = tres[k + "_w"].numpy()
        np.testing.assert_array_equal(w, np.asarray(jres[k + "_w"]))
        np.testing.assert_array_equal(tres[k].numpy()[w > 0],
                                      np.asarray(jres[k])[w > 0])
        owned += int(w.sum())
    assert 0 < owned < 7 * 11


def _water(d, n):
    from ddcmd_tpu_torch.models import martini_water

    os.makedirs(d, exist_ok=True)
    martini_water(d, n=n)
    return d


@pytest.fixture(scope="module")
def water(tmp_path_factory):
    """The water box at n = 1700 (6.1 nm): its (2,2,2) bricks clear 2
    rlist, so the pick takes the cells engine.  With the JAX package's
    f64 Simulation's first energy and forces on it."""
    from ddcmd_tpu.models import load as j_load
    from ddcmd_tpu.run.simulate import Simulation as JSimulation

    d = _water(str(tmp_path_factory.mktemp("water")), 1700)
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    return d, float(sim.ss.energy.eion), np.asarray(sim.ss.state.f[:1700],
                                                     np.float64)


def test_cells_engine_against_list_engine(tmp_path, water):
    """On the water box at (2,2,2) the pick takes the cells engine
    (#6's plain version here); DDCMD_SHARD_ENGINE=nlist forces the list
    engine.  Each engine's first energy and forces lie within the f32
    tolerance (2e-5 of the scale) of the JAX package's f64 Simulation,
    so within twice that of each other, their virials within 1e-4; the
    list engine runs a chunk keeping every particle."""
    water, e64, f64 = water
    outs = {}
    for eng in ("auto", "nlist"):
        out = str(tmp_path / f"{eng}.npz")
        (tmp_path / eng).mkdir()
        ranks.run_ranks(ranks.mesh_forces, 8, tmp_path / eng, water, SHAPE,
                        out, None if eng == "auto" else eng, "float32",
                        20 if eng == "nlist" else 0)
        outs[eng] = np.load(out)
    a, b = outs["auto"], outs["nlist"]
    assert str(a["engine"]) == "pallas" and str(b["engine"]) == "nlist"
    assert not (bool(a["ov"]) or bool(b["ov"]))
    scale = np.abs(f64).max()
    for z in (a, b):
        assert float(z["e"]) == pytest.approx(e64, rel=2e-5)
        assert np.abs(z["f"] - f64).max() <= 2e-5 * scale
    assert np.abs(a["f"] - b["f"]).max() <= 4e-5 * scale
    np.testing.assert_allclose(b["virial"], a["virial"], rtol=1e-4,
                               atol=1e-4 * np.abs(a["virial"]).max())
    assert bool(b["finite"]) and int(b["loop"]) == 20
    assert sorted(b["gids"].tolist()) == list(range(1700))


def test_forced_pallas_raises(tmp_path, monkeypatch):
    """DDCMD_SHARD_ENGINE=pallas on decks the cells engine cannot take
    raises ValueError, as the JAX package's pick does
    (parallel_sim.py:681-682): bricks narrower than 2 rlist on a 2-brick
    axis (the 400-bead box at (2,1,1), through the pick alone), an f64
    run, a PAIR table; without the knob they take the list engine."""
    from ddcmd_tpu_torch.models import lj_fluid, load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    d = _water(str(tmp_path / "w"), 400)
    t = str(tmp_path / "t")
    os.makedirs(t)
    lj_fluid(t, n=64, table=True)
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
    monkeypatch.setattr(ps, "shape", (2, 1, 1))
    assert ps._pick_shard_engine(ps._live_L()) == "nlist"
    monkeypatch.setenv("DDCMD_SHARD_ENGINE", "pallas")
    with pytest.raises(ValueError, match="pallas infeasible: axis 0"):
        ps._pick_shard_engine(ps._live_L())
    with pytest.raises(ValueError, match="pallas infeasible: dtype"):
        ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu",
                           dtype=torch.float64)
    with pytest.raises(ValueError, match="pallas infeasible: a PAIR Table"):
        ParallelSimulation(*load(t), shape=(1, 1, 1), device="cpu")
    monkeypatch.delenv("DDCMD_SHARD_ENGINE")
    for deck, kw in ((d, dict(dtype=torch.float64)), (t, {})):
        ps = ParallelSimulation(*load(deck), shape=(1, 1, 1), device="cpu",
                                **kw)
        assert ps.shard_engine == "nlist"
        assert np.isfinite(ps.first_energy())


def test_three_brick_axis_needs_rlist(tmp_path, monkeypatch):
    """On an axis of three or more bricks the staged halo reaches one
    brick, so a brick narrower than rlist there raises ValueError on
    either engine (the 400-bead box, 3.7 nm, cut into three 1.23 nm
    bricks against rlist 1.5 nm); two bricks on the axis (1.88 nm,
    narrower than 2 rlist) take the list engine."""
    import dataclasses

    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    d = _water(str(tmp_path / "w"), 400)
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")
    L = ps._live_L()
    for n_x, ok in ((3, False), (2, True)):
        monkeypatch.setattr(ps, "shape", (n_x, 1, 1))
        monkeypatch.setattr(ps, "plan", dataclasses.replace(
            ps.plan, shape=(n_x, 1, 1)))
        assert L[0] / n_x < (1 if n_x > 2 else 2) * ps.plan.rlist
        if ok:
            ps._check_reach(L)
            assert ps._pick_shard_engine(L) == "nlist"
        else:
            with pytest.raises(ValueError, match="reaches one brick"):
                ps._check_reach(L)


def test_eam_dF_halo_over_ranks(tmp_path):
    """Unfitted TABULAR EAM (nc = 6, 864 atoms, 2.17 nm box) at (2,2,2)
    on the list engine in f64: each ghost's embedding derivative comes
    from its owner through the second halo, and the first energy and
    forces equal the JAX package's f64 Simulation on its list engine
    (1e-10 relative, 1e-10 of the force scale)."""
    import chip_smoke
    from ddcmd_tpu.models import load as j_load
    from ddcmd_tpu.run.simulate import Simulation as JSimulation

    d = str(tmp_path / "tab")
    os.makedirs(d)
    chip_smoke.tabular_eam_deck(d, 6, 10)
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    f0 = np.asarray(sim.ss.state.f[:n], np.float64)
    e0 = float(sim.ss.energy.eion)
    out = str(tmp_path / "eam.npz")
    ranks.run_ranks(ranks.mesh_forces, 8, tmp_path, d, SHAPE, out, None,
                    "float64")
    z = np.load(out)
    assert str(z["engine"]) == "nlist" and not bool(z["ov"])
    assert abs(float(z["e"]) - e0) <= 1e-10 * abs(e0)
    assert np.abs(z["f"] - f0).max() <= 1e-10 * np.abs(f0).max()
