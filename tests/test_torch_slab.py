"""The 1-D slab engine (parallel/slab.py, parallel/step.py) over four gloo
ranks, against the JAX package.

Ports tests/test_parallel.py:53, 82, 145: the dry run's synthetic system
(L = 6.4 nm, 13^3 particles, two species) split into four x-slabs,
uniform and under ZRAMP walls, whose first forces match the JAX
single-device list evaluation, and whose steps and migration keep every
particle; a row past the +x seam keeps its pairs (the JAX slab windows
compare the raw x and would ship it the other way); one slab exchanges
nothing; distribute / collect round-trip on the host, and a slab plan's
pxyz.  One spawn of four ranks checks the ring.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from ddcmd_tpu.nbr.celllist import CellGrid as JCellGrid
from ddcmd_tpu.nbr.celllist import build_neighbor_list as j_build
from ddcmd_tpu.potentials.martini import martini_nonbond as j_martini

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

N_DEV = 4
SKIN = 0.15
TABLE_KEYS = ("sigma", "eps", "shift", "rcut2", "krf", "crf", "keR")


@pytest.fixture(scope="module")
def spec():
    """The dry run's system (test_parallel.setup), its ZRAMP walls
    (work_power 1) and the row of the largest x moved 0.05 nm past the +x
    seam."""
    from ddcmd_tpu_torch.parallel.loadbalance import zramp_walls

    L = 6.4
    n = int(np.ceil(L / 0.5)) ** 3
    arrays, L, rcut, tables = graft._synthetic_system(n=n, L=L, rcut=0.6,
                                                      sigma0=0.4)
    z = {k: np.asarray(v) for k, v in arrays.items()}
    z["gid"] = np.arange(n, dtype=np.int64)
    z.update({k: np.asarray(tables[k], np.float64) for k in TABLE_KEYS})
    k = int(np.argmax(z["r"][:, 0]))
    z.update(L=L, rcut=rcut, skin=SKIN, seam_gid=k,
             seam_x=0.5 * L + 0.05 - L,
             walls=np.asarray(zramp_walls(z["r"][:, 0].astype(np.float32),
                                          -L / 2, L, N_DEV, work_power=1)))
    return z


def _jax_list(z, dtype, r=None):
    """The JAX package's single-device list evaluation (one jit): (e, f,
    virial)."""
    L, n = float(z["L"]), len(z["r"])
    grid = JCellGrid.plan([L] * 3, float(z["rcut"]), SKIN, n, n)
    tables = {k: jnp.asarray(z[k], dtype) for k in TABLE_KEYS}

    @jax.jit
    def run(rj, q, species):
        ones = jnp.ones(n, dtype)
        Lv = jnp.asarray([L] * 3, dtype)
        nbr, _, ov = j_build(rj, ones, Lv, grid)
        f, e, virial, _, _ = j_martini(rj, q, species, ones, nbr, Lv, tables)
        return f, e, virial, ov

    f, e, virial, ov = run(jnp.asarray(z["r"] if r is None else r, dtype),
                           jnp.asarray(z["q"], dtype),
                           jnp.asarray(z["species"]))
    assert not bool(ov)
    return float(e), np.asarray(f, np.float64), np.asarray(virial)


@pytest.fixture(scope="module")
def ring(spec, tmp_path_factory):
    """torch_mesh_ranks.slab_legs on four gloo ranks."""
    tmp = tmp_path_factory.mktemp("slab4")
    p = str(tmp / "spec.npz")
    np.savez(p, **spec)
    out = str(tmp / "out.npz")
    ranks.run_ranks(ranks.slab_legs, N_DEV, tmp, p, out)
    return dict(np.load(out))


def _forces_close(z, key, f_ref, e_ref, tol=1e-5):
    assert not z[f"{key}_ov"]
    assert float(z[f"{key}_e"]) == pytest.approx(e_ref, rel=tol, abs=1e-2)
    scale = max(1.0, np.abs(f_ref).max())
    assert np.abs(z[f"{key}_f"] - f_ref).max() / scale < tol


def test_sharded_forces_match_single_device(spec, ring):
    """Four uniform slabs: first energy and virial as the JAX test holds
    them, forces by gid within 1e-5 of the scale."""
    e_ref, f_ref, virial_ref = _jax_list(spec, jnp.float32)
    _forces_close(ring, "uniform", f_ref, e_ref)
    assert ring["uniform_virial"] == pytest.approx(virial_ref, rel=1e-3,
                                                   abs=1.0)


def test_sharded_step_and_migration(spec, ring):
    """Five LANGEVIN steps (finite energies, no overflow) and a migration
    that keeps every particle once."""
    assert not ring["uniform_ov_steps"].any() and not ring["uniform_ov_m"]
    assert np.isfinite(ring["uniform_scalars"][:, :2]).all()
    assert bool(ring["uniform_finite"])
    assert sorted(ring["uniform_gids"].tolist()) == spec["gid"].tolist()


def test_sharded_forces_match_with_zramp_walls(spec, ring):
    """Four slabs between ZRAMP walls: balanced-ish counts, the same first
    forces, three steps and a migration that keep every particle."""
    e_ref, f_ref, _ = _jax_list(spec, jnp.float32)
    counts = ring["zramp_counts"]
    assert counts.max() - counts.min() <= counts.max() // 4
    _forces_close(ring, "zramp", f_ref, e_ref)
    assert not ring["zramp_ov_steps"].any() and not ring["zramp_ov_m"]
    assert sorted(ring["zramp_gids"].tolist()) == spec["gid"].tolist()


def _jax_slab_first(z, move):
    """The JAX slab engine's first energy on four CPU devices in f64, the
    row move[0] of slab 3 given x = move[1] after the distribution."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ddcmd_tpu.core.groups import Group, GroupTable
    from ddcmd_tpu.parallel.slab import SlabPlan as JSlabPlan
    from ddcmd_tpu.parallel.slab import distribute as j_distribute
    from ddcmd_tpu.parallel.step import AXIS, make_mesh
    from ddcmd_tpu.parallel.step import make_sharded_step as j_make

    f64 = jnp.float64
    L, n = float(z["L"]), len(z["r"])
    plan = JSlabPlan(n_dev=N_DEV, local_cap=4 * n // N_DEV,
                     halo_cap=4 * n // N_DEV, migrate_cap=256,
                     rlist=float(z["rcut"]) + SKIN)
    grid = JCellGrid.plan([L] * 3, float(z["rcut"]), SKIN, n,
                          plan.local_cap + 2 * plan.halo_cap)
    mesh = make_mesh(N_DEV)
    coeffs = GroupTable.build([Group(name="free", index=0, type="FREE")]
                              ).coefficients(0.0, 0.01, dtype=f64)
    _, first, _ = j_make(mesh, plan, grid,
                         {k: jnp.asarray(z[k], f64) for k in TABLE_KEYS},
                         coeffs, dt=0.02, box_lengths=[L] * 3,
                         species_lj_type=np.array([0, 1], np.int32),
                         n_global=n)
    g = z["gid"]
    arrays = {k: np.asarray(z[k], np.float64)
              for k in ("r", "v", "q", "mass")}
    arrays.update(species=z["species"], group=z["group"],
                  gid=np.stack([g.astype(np.uint32), (g >> 32).astype(
                      np.uint32)], axis=1))
    buf, mask, _ = j_distribute(arrays, L, plan)
    buf["r"][mask & (buf["gid"][:, 0] == move[0]), 0] = move[1]
    shard = lambda a: jax.device_put(                        # noqa: E731
        jnp.asarray(a), NamedSharding(mesh, P(AXIS)))
    _, e, _, ov = first({k: shard(v) for k, v in buf.items()}, shard(mask),
                        jax.random.PRNGKey(0))
    assert not int(ov)
    return float(e)


def test_seam_row_keeps_its_pairs(spec, ring):
    """f64, the row of the largest x moved 0.05 nm past the +x seam (x
    wrapped to the far side, still owned by slab 3): the windows measured
    from each slab's centre ship it to slab 0, and the first energy and
    forces equal the single-device list of the same positions (1e-10).
    The JAX slab engine compares the raw x, ships the row to slab 2 and
    drops slab 0's pairs with it (ROADMAP section 3)."""
    r = spec["r"].copy()
    k, x_new = int(spec["seam_gid"]), float(spec["seam_x"])
    r[k, 0] = x_new
    e_ref, f_ref, _ = _jax_list(spec, jnp.float64, r)
    assert abs(float(ring["seam_e"]) - e_ref) <= 1e-10 * abs(e_ref)
    assert np.abs(ring["seam_f"] - f_ref).max() <= 1e-10 * np.abs(f_ref).max()
    je = _jax_slab_first(spec, (k, x_new))
    assert abs(je - e_ref) > 1e-4 * abs(e_ref)


def test_one_slab_exchanges_nothing(spec):
    """A ring of one (no process group): the first energy equals the JAX
    single-device list's, 1e-10 in f64; a step and a migration keep every
    row on the rank."""
    from ddcmd_tpu_torch.core.groups import Group, GroupTable
    from ddcmd_tpu_torch.parallel.slab import distribute
    from ddcmd_tpu_torch.parallel.step import make_mesh, make_sharded_step

    plan, grid, tables, L, arrays = ranks._slab_setup(spec,
                                                      dtype=torch.float64)
    coeffs = GroupTable.build([Group("free", 0, "FREE")]).coefficients(
        0.0, 0.01, dtype=torch.float64)
    mesh = make_mesh()
    assert mesh.shape == (1, 1, 1) and plan.n_dev == 1
    step, first, migrate = make_sharded_step(
        mesh, plan, grid, tables, coeffs, 0.02, [L] * 3, np.array([0, 1]),
        len(spec["r"]))
    buf, mask, _ = distribute(arrays, L, plan)
    fields = {k: torch.as_tensor(v) for k, v in buf.items()}
    mask = torch.as_tensor(mask)
    f, e, _, ov = first(fields, mask)
    e_ref, f_ref, _ = _jax_list(spec, jnp.float64)
    assert not ov and abs(float(e) - e_ref) <= 1e-10 * abs(e_ref)
    fields, f, scal, ov = step(fields, mask, f, 0)
    fields, mask, f, ov_m = migrate(fields, mask, f)
    assert not (ov or ov_m) and int(mask.sum()) == len(spec["r"])


def test_distribute_collect_round_trip(spec):
    """distribute then collect on the host returns every row once, each
    x inside its slab's bounds (uniform and walls)."""
    from ddcmd_tpu_torch.parallel.slab import (SlabPlan, collect,
                                               distribute, slab_bounds)

    L, n = float(spec["L"]), len(spec["r"])
    arrays = {k: spec[k] for k in ("r", "v", "species", "gid")}
    for walls in (None, tuple(spec["walls"])):
        plan = SlabPlan(n_dev=N_DEV, local_cap=n, halo_cap=n // 2,
                        migrate_cap=256, rlist=0.75, walls=walls)
        buf, mask, counts = distribute(arrays, L, plan)
        assert counts.sum() == n
        back = collect(buf, mask, plan)
        order = np.argsort(back["gid"])
        for k, a in arrays.items():
            np.testing.assert_array_equal(back[k][order], a)
        for d in range(N_DEV):
            lo, hi = slab_bounds(L, N_DEV, d, walls)
            rows = slice(d * n, d * n + counts[d])
            x = buf["r"][rows, 0]
            assert ((x >= lo - 1e-6) & (x < hi + 1e-6)).all()


def test_slab_plan_pxyz(spec, tmp_path):
    """io/pxyz.py writes a slab plan as the mesh shape n 1 1: a uniform
    plan's text equals the JAX package's for its SlabPlan; a ZRAMP plan's
    walls read back as the x walls of an (n, 1, 1) tensor plan."""
    from ddcmd_tpu.io.pxyz import write_pxyz as j_write
    from ddcmd_tpu.parallel.slab import SlabPlan as JSlabPlan
    from ddcmd_tpu_torch.io.pxyz import restore_plan_lb, write_pxyz
    from ddcmd_tpu_torch.parallel.slab import SlabPlan

    L = [float(spec["L"])] * 3
    kw = dict(n_dev=N_DEV, local_cap=100, halo_cap=50, migrate_cap=25,
              rlist=0.75)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    write_pxyz(a, L, SlabPlan(**kw))
    j_write(b, L, JSlabPlan(**kw))
    text = open(a).read()
    assert f"shape={N_DEV} 1 1;" in text and text == open(b).read()
    walls = tuple(float(w) for w in spec["walls"])
    write_pxyz(a, L, SlabPlan(**kw, walls=walls))
    assert f"shape={N_DEV} 1 1;" in open(a).read()
    w, vor = restore_plan_lb(a, (N_DEV, 1, 1), "tensor")
    assert vor is None
    np.testing.assert_allclose(w[0], walls, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(w[1], [0.0, 1.0])
