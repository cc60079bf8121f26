"""CHARMM under the mesh's brick list engine, against the JAX package.

The dry run's CHARMM leg (__graft_entry__.py:474-510): the c36 solvated
tripeptide fixture (tests/test_charmm_c36.make_solvated_fixture, L = 32
A, 102 atoms) at (2,2,1) in f64, its bricks narrower than 2 rlist, on
four gloo ranks: first energy within 1e-8 of the JAX package's
Simulation(engine="nlist", dtype=float64), forces by gid, one chunk.
Its 30-member exclusion component and its junction and CMAP terms take
the list engine and the per-term gid resolver.  Excluded partners are
absent from the list (masked by gid); in f32 that masked list holds the
f64 forces to 1.8e-6 of the scale where the JAX mesh's list engine,
which computes the excluded pairs and subtracts them, is 1.4e-3 off.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
from test_charmm_c36 import make_solvated_fixture

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

# phase 19's f32-against-f64 gates of the list engine: (e rel, force
# over the scale)
F32_GATES = (1e-4, 3e-4)


@pytest.fixture(scope="module")
def c36(tmp_path_factory):
    """The dry run's fixture and the JAX package's f64 list-engine first
    energy and forces on it."""
    d = tmp_path_factory.mktemp("c36")
    make_solvated_fixture(d, L=32.0, nve=True, dt_fs=0.25)
    d = str(d)
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    return d, n, float(sim.ss.energy.eion), np.asarray(sim.ss.state.f[:n],
                                                       np.float64)


def test_charmm_leg_f64(tmp_path, c36):
    """(2,2,1) in f64: the list engine (bricks of 16 A, narrower than 2
    rlist); first energy within 1e-8 relative of the JAX f64 Simulation
    on its list engine, forces by gid within 1e-8 of the scale; one chunk
    with finite forces and every atom owned once."""
    d, n, e64, f64 = c36
    out = str(tmp_path / "c36.npz")
    ranks.run_ranks(ranks.mesh_forces, 4, tmp_path, d, (2, 2, 1), out, None,
                    "float64", 10)
    z = np.load(out)
    assert str(z["engine"]) == "nlist" and not bool(z["ov"])
    ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu",
                            dtype=torch.float64)
    assert ps._live_L()[0] / 2 < 2 * ps.plan.rlist
    assert abs(float(z["e"]) - e64) <= 1e-8 * abs(e64)
    assert np.abs(z["f"] - f64).max() <= 1e-8 * np.abs(f64).max()
    assert bool(z["finite"]) and int(z["loop"]) == 10
    assert sorted(z["gids"].tolist()) == list(range(n))


def test_excluded_partners_absent_from_list(c36):
    """On the c36 fixture the list engine's list holds no excluded
    partner of any row (matched by gid), while the same list without the
    mask holds some (the 1-2 and 1-3 partners lie within rlist): the
    excluded pairs are never computed, so nothing is subtracted."""
    d = c36[0]
    ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu",
                            dtype=torch.float64)
    st = ps.step_fn
    assert ps.shard_engine == "nlist" and st.excl
    ex = ps.fields["exgid"]

    def hits():
        nbr, pool_gid, pool_mask, ov = st.neighbor_list(ps.fields, ps.mask)
        assert not bool(ov)
        g = torch.cat([torch.where(pool_mask, pool_gid, -2),
                       pool_gid.new_full((1,), -3)])[nbr]
        return int(torch.any(g[:, :, None] == ex[:, None, :], -1)[
            ps.mask].sum())

    assert hits() == 0
    st.excl = False
    try:
        assert hits() > 100
    finally:
        st.excl = True


def test_f32_masked_list_against_jax_subtract(c36, monkeypatch):
    """f32 at (1,1,1): the port's list engine (excluded pairs masked by
    gid) holds the f64 first energy and forces within phase 19's gates;
    the JAX mesh's list engine (DDCMD_SHARD_ENGINE=nlist: excluded pairs
    computed, then subtracted) misses them on the same deck by more than
    100 times the port's error (ROADMAP section 3)."""
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation as JPS

    d, n, e64, f64 = c36
    scale = np.abs(f64).max()
    ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
    e = ps.first_energy()
    f = ps.gather_by_gid(("f",))["f"]
    e_err, f_err = abs(e - e64) / abs(e64), np.abs(f - f64).max() / scale
    assert e_err <= F32_GATES[0] and f_err <= F32_GATES[1]
    monkeypatch.setenv("DDCMD_SHARD_ENGINE", "nlist")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JPS(*j_load(d), shape=(1, 1, 1), dtype=jnp.float32)
    je = jp.first_energy()
    m = np.asarray(jp.mask)
    jf = np.zeros((n, 3))
    jf[np.asarray(jp.fields["gid"])[m][:, 0].astype(np.int64)] = \
        np.asarray(jp.f)[m]
    assert abs(je - e64) / abs(e64) > 100 * e_err
    assert np.abs(jf - f64).max() / scale > 100 * f_err

