"""The port's brick mesh under load-balanced walls (LOADBALANCE ZRAMP and
BISECTION) over 8 gloo ranks, against the JAX package.

The deck is tests/torch_mesh_ranks.skewed_water: a 9.3 nm water box with
beads removed so that ORCB's y walls differ by ~0.24 of the box between
the two x-slabs (more than rlist = 1.5 nm) while every (2,2,2) brick
stays wider than 2 rlist.  Walls are held to the JAX package's host
functions on the same positions; first forces, energy and virial to the
JAX package's single-device (N,K)-list evaluation in float64.  The force
tolerance is this deck's f32 floor: the port's uniform-wall mesh, whose
path the existing tests hold at 2e-5 on a 6.1 nm box, sits 2.5e-5 of the
force scale from the f64 forces here, so the walls are held at 4e-5 (the
energy keeps its 2e-5 relative).

Both halos are held to the set of particles within rlist of each brick:
at (2,2,2) the JAX package's halo is complete under both wall kinds (it
drops no pairs across the ORCB x face); with three bricks on a forwarded
axis it misses ghosts across the periodic seam, which the port's halo
holds (parallel/brick.py).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.parallel.brick import gid64

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

SHAPE = (2, 2, 2)
RLIST = 1.5                      # nm: 11 A rmax + 4 A deltaR
F_TOL, E_TOL = 4e-5, 2e-5


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("skewed"))
    ranks.skewed_water(d)
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    e = sim.ss.energy
    # the f32 positions both packages' meshes start from
    sd = j_build_system(j_load(d)[0], d, dtype=jnp.float32)
    L = float(np.asarray(sd.box.lengths, np.float64)[0])
    return dict(d=d, n=n, L=L, e=float(e.eion),
                f=np.asarray(sim.ss.state.f[:n], np.float64),
                virial=np.asarray(e.virial, np.float64),
                r=np.asarray(sd.state.r[:n]),
                gid=gid64(sd.collection.gid))


def _seam_case():
    """test_seam_crossing_migrates_to_its_brick's state: 2000 particles in
    a unit box under ORCB walls at (2,2,2), rlist 0.08, and the row of
    the top x-slab moved to the unwrapped fraction x_new."""
    shape, L, rlist = (2, 2, 2), 1.0, 0.08
    r = (np.random.default_rng(4).random((2000, 3)) - 0.5).astype(
        np.float32)
    walls = tuple(_orcb(r, shape, rlist))
    fx = r[:, 0] + 0.5
    row = int(np.nonzero(fx > walls[0][1] + 0.05)[0][0])
    return shape, walls, r, L, rlist, row, np.float32(0.503)


@pytest.fixture(scope="module")
def eight(deck, tmp_path_factory):
    """One spawn of eight gloo ranks (torch_mesh_ranks.run_legs) for the
    tests below, each leg on its own copy of the deck: the first forces
    under ZRAMP and BISECTION walls, the BISECTION run with rebalances,
    the ORCB misplacement at (4,2,1) and the seam-crossing migration.
    {leg: the npz path (prefix) it wrote}."""
    tmp = tmp_path_factory.mktemp("walls8")
    out, todo = {}, []

    def deck_copy(name, *lb, **kw):
        d = str(tmp / name)
        shutil.copytree(deck["d"], d)
        ranks.set_loadbalance(d, *lb, **kw)
        return d

    for kind in ("ZRAMP", "BISECTION"):
        out[kind] = str(tmp / f"ff_{kind}.npz")
        todo.append(("lb_first_forces",
                     (deck_copy(kind, kind), SHAPE, out[kind])))
    out["run"] = str(tmp / "run.npz")
    todo.append(("lb_run", (deck_copy("run", "BISECTION", rate=5,
                                      update_rate=5), SHAPE, 15,
                            out["run"])))
    out["mis"] = str(tmp / "mis.npz")
    todo.append(("orcb_misplaced", (deck_copy("mis", "BISECTION",
                                              update_rate=5), (4, 2, 1),
                                    out["mis"])))
    out["seam"] = str(tmp / "seam")
    todo.append(("seam_migrate", _seam_case() + (out["seam"],)))
    ranks.run_ranks(ranks.run_legs, 8, tmp, todo)
    return out


def _jax_walls(kind, r, L):
    """The JAX package's walls from these positions (its __init__)."""
    from ddcmd_tpu.parallel.loadbalance import (clamp_walls, orcb_walls,
                                                tensor_walls)

    Lv = [L] * 3
    if kind == "BISECTION":
        return orcb_walls(r, Lv, SHAPE, min_frac=(1.05 * RLIST / L,) * 3)
    return [clamp_walls(w, 1.05 * RLIST / L)
            for w in tensor_walls(r, Lv, SHAPE, work_power=2)]


def _required(r, L, walls, shape, rlist=RLIST):
    """{rank: set of gid rows} of the particles within rlist of each
    brick (box distance, periodic) that the brick does not own."""
    from ddcmd_tpu_torch.parallel.brick import _axis_bounds
    from ddcmd_tpu_torch.parallel.loadbalance import walls_assign

    f = r.astype(np.float64) / L + 0.5
    f -= np.floor(f)
    cx, cy, cz = walls_assign(f, walls, shape)
    owner = (cx * shape[1] + cy) * shape[2] + cz
    out = {}
    for rank in range(int(np.prod(shape))):
        ix, rem = divmod(rank, shape[1] * shape[2])
        i3 = (ix,) + divmod(rem, shape[2])
        near = np.ones(len(f), bool)
        for a in range(3):
            lo, hi = _axis_bounds(shape[a], i3[a], walls[a], i3[:a])
            d = f[:, a] - 0.5 - 0.5 * (lo + hi)
            d -= np.round(d)
            near &= np.abs(d) < 0.5 * (hi - lo) + rlist / L
        out[rank] = set(np.nonzero(near & (owner != rank))[0].tolist())
    return out


@pytest.mark.parametrize("kind", ["ZRAMP", "BISECTION"])
def test_walls_first_forces_match_jax(deck, eight, kind):
    """(2,2,2) under ZRAMP (tensor walls) and BISECTION (ORCB walls): the
    walls equal the JAX package's from the same positions; first forces,
    energy and virial match the JAX package's f64 Simulation; each rank's
    halo holds every particle within rlist of its brick exactly once."""
    out = eight[kind]
    z = np.load(out)
    assert not bool(z["ov"])
    jw = _jax_walls(kind, deck["r"], deck["L"])
    for a in range(3):
        np.testing.assert_array_equal(z[f"w{a}"], np.asarray(jw[a]))
    if kind == "BISECTION":
        wy = z["w1"]
        assert abs(wy[0, 1] - wy[1, 1]) * deck["L"] > RLIST   # y walls differ
    assert float(z["e"]) == pytest.approx(deck["e"], rel=E_TOL)
    scale = max(1.0, float(np.abs(deck["f"]).max()))
    assert float(np.abs(z["f"] - deck["f"]).max()) <= F_TOL * scale
    np.testing.assert_allclose(z["virial"], deck["virial"], rtol=1e-4,
                               atol=1e-4 * np.abs(deck["virial"]).max())
    need = _required(deck["r"], deck["L"], jw, SHAPE)
    row = {int(g): i for i, g in enumerate(deck["gid"])}
    for rank in range(8):
        g = np.load(f"{out}_ghosts_{rank}.npz")
        got = [row[int(x)] for x in g["gid"]]
        assert not bool(g["ov"])
        assert len(got) == len(set(got))                   # each once
        assert not set(got) & {row[int(x)] for x in g["own"]}
        assert need[rank] <= set(got), (rank, len(need[rank] - set(got)))


def _jax_ghosts(r, L, walls, shape, rlist):
    """{rank: set of rows} of the JAX package's staged halo exchange."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ddcmd_tpu.parallel.brick import (BrickPlan as JPlan,
                                          distribute_bricks as jdist,
                                          halo_exchange_3d as jhalo)
    from ddcmd_tpu.parallel.brickstep import make_brick_mesh

    n = len(r)
    g = np.arange(n, dtype=np.int64)
    arrays = dict(r=r, gid=np.stack([g.astype(np.uint32),
                                     np.zeros(n, np.uint32)], axis=1))
    plan = JPlan(shape=shape, local_cap=n, halo_cap=n, migrate_cap=64,
                 rlist=rlist, walls=tuple(walls))
    buf, mask, _ = jdist(arrays, [L] * 3, plan)
    mesh = make_brick_mesh(shape)
    PS = P(("bx", "by", "bz"))

    def go(fields, m):
        gh, gm, ov = jhalo(fields, m, jnp.asarray([L] * 3, jnp.float32),
                           plan)
        return gh["gid"][:, 0], gm, ov

    f = jax.jit(jax.shard_map(go, mesh=mesh, in_specs=(
        {"r": PS, "gid": PS}, PS), out_specs=(PS, PS, P()),
        check_vma=False))
    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   NamedSharding(mesh, PS))
    gg, gm, ov = f({k: put(v) for k, v in buf.items()}, put(mask))
    assert not bool(ov)
    k = int(np.prod(shape))
    gg, gm = np.asarray(gg).reshape(k, -1), np.asarray(gm).reshape(k, -1)
    return {i: set(gg[i][gm[i]].tolist()) for i in range(k)}


def test_jax_halo_complete_on_two_brick_axes(deck):
    """Finding: at (2,2,2) the JAX package's one-sided windows forward
    every ghost a brick needs under both wall kinds, also across the x
    face of ORCB slabs whose y walls differ by more than rlist: it drops
    no pairs there."""
    L, r = deck["L"], deck["r"]
    for kind in ("ZRAMP", "BISECTION"):
        walls = _jax_walls(kind, r, L)
        need = _required(r, L, walls, SHAPE, RLIST)
        got = _jax_ghosts(r, L, walls, SHAPE, RLIST)
        assert all(need[k] <= got[k] for k in range(8)), kind


def test_orcb_three_brick_axis_jax_misses_port_holds(tmp_path):
    """Finding: with three bricks on y and slab 1's first y brick
    reaching past slab 0's second wall, brick (0, 2) needs ghosts of
    brick (1, 0) across the periodic seam; the JAX package's exchange
    sends them to (0, 1) and (0, 2) misses them (and their pairs).  The
    port forwards them: every rank holds every particle within rlist of
    its brick, once."""
    shape, L, rlist = (2, 3, 1), 1.0, 0.08
    r = (np.random.default_rng(9).random((3000, 3)) - 0.5).astype(
        np.float32)
    walls = (np.array([0.0, 0.5, 1.0]),
             np.array([[0.0, 0.3, 0.5, 1.0], [0.0, 0.7, 0.85, 1.0]]),
             np.tile(np.array([0.0, 1.0]), (2, 3, 1)))
    need = _required(r, L, walls, shape, rlist)
    got = _jax_ghosts(r, L, walls, shape, rlist)
    assert len(need[2] - got[2]) > 0
    out = str(tmp_path / "halo")
    ranks.run_ranks(ranks.halo_gids, 6, tmp_path, shape, walls, r, L, rlist,
                    out)
    for k in range(6):
        z = np.load(f"{out}_{k}.npz")
        g = z["gid"].tolist()
        assert not bool(z["ov"]) and len(g) == len(set(g))
        assert need[k] <= set(g), (k, len(need[k] - set(g)))


def test_rebalance_at_rate_with_migration(deck, eight):
    """BISECTION at rate 5 on a 5-step cadence: 15 steps rebalance at
    loops 5 and 10, each chunk migrating; every particle owned once
    before and after, finite forces, walls still ORCB."""
    z = np.load(eight["run"])
    assert int(z["loop"]) == 15 and int(z["n_rebalance"]) == 2
    for key in ("gids0", "gids1"):
        np.testing.assert_array_equal(np.sort(z[key]), np.sort(deck["gid"]))
    assert bool(z["finite"])
    assert z["w1"].shape == (2, 3) and z["w2"].shape == (2, 2, 3)
    assert not np.array_equal(z["w1"], z["aw1"])       # walls moved


def test_orcb_misplacement_recovered_by_redistribute(deck, eight):
    """(4,2,1) under BISECTION: a particle moved two x-slabs away is left
    one brick short by the chunk's staged hop; the ORCB containment check
    flags it and the run's ladder redistributes once, keeping every
    particle."""
    z = np.load(eight["mis"])
    assert int(z["redistributed"]) == 1
    assert int(z["loop"]) == 5 and bool(z["finite"])
    np.testing.assert_array_equal(np.sort(z["gids1"]), np.sort(deck["gid"]))


def test_seam_crossing_migrates_to_its_brick(eight):
    """Finding: a particle of the top x-slab that drifted across the
    periodic seam (x fraction 0.503, unwrapped) under ORCB walls.  The
    JAX package's migration sends it toward the other face and its
    containment check flags an overflow (the redistribute rung then
    faces the same on every retry); the port's migration hands it to
    the bottom slab's brick, no overflow, every particle owned once."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ddcmd_tpu.parallel.brick import (BrickPlan as JPlan,
                                          distribute_bricks as jdist,
                                          migrate_3d as jmig)
    from ddcmd_tpu.parallel.brickstep import make_brick_mesh

    shape, walls, r, L, rlist, row, x_new = _seam_case()
    n = len(r)
    g = np.arange(n, dtype=np.int64)
    plan = JPlan(shape=shape, local_cap=n, halo_cap=n, migrate_cap=64,
                 rlist=rlist, walls=walls)
    buf, mask, _ = jdist(dict(r=r, gid=np.stack(
        [g.astype(np.uint32), np.zeros(n, np.uint32)], axis=1)),
        [L] * 3, plan)
    buf["r"] = buf["r"].copy()
    buf["r"][np.nonzero((buf["gid"][:, 0] == row) & mask)[0][0], 0] = \
        x_new * L
    mesh = make_brick_mesh(shape)
    PS = P(("bx", "by", "bz"))
    f = jax.jit(jax.shard_map(
        lambda fl, m: jax.lax.pmax(jmig(
            fl, m, jnp.asarray([L] * 3, jnp.float32), plan)[2],
            ("bx", "by", "bz")),
        mesh=mesh, in_specs=({"r": PS, "gid": PS}, PS), out_specs=P(),
        check_vma=False))
    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   NamedSharding(mesh, PS))
    assert bool(f({k: put(v) for k, v in buf.items()}, put(mask)))
    res = [np.load(f"{eight['seam']}_{k}.npz") for k in range(8)]
    assert not any(bool(z["ov"]) for z in res)
    own = np.concatenate([z["own"] for z in res])
    np.testing.assert_array_equal(np.sort(own), g)
    holder = [k for k, z in enumerate(res) if row in z["own"]]
    assert holder and holder[0] // 4 == 0          # the bottom x-slab


def _orcb(r, shape, rlist):
    from ddcmd_tpu.parallel.loadbalance import orcb_walls

    return orcb_walls(r, [1.0] * 3, shape, min_frac=(1.05 * rlist,) * 3)


def test_rows_on_an_orcb_wall_are_core_once(tmp_path):
    """Finding: on the dry run's zRamp bilayer start (__graft_entry__.py:
    410-444) ORCB splits z halfway between equal coordinates, so a z wall
    lands on a lattice layer.  The JAX package bins each brick's rows by
    u = (x - centre) / span in f32 (pallas_shard.bin_pool_ext), which
    rounds differently in the two bricks' frames: rows of that layer fall
    in two bricks' cores or in none, and their pairs across the wall
    count twice or not at all.  The port bins by the wall comparison that
    decides ownership (shard_cells.bin_frac): each row lies in exactly one
    core."""
    from ddcmd_tpu.parallel import pallas_shard as jps
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load, martini_bilayer
    from ddcmd_tpu_torch.parallel import shard_cells as sc
    from ddcmd_tpu_torch.parallel.loadbalance import orcb_walls

    d = str(tmp_path)
    martini_bilayer(d, nx=12, ny=12, water_nm=1.2)
    sd = build_system(load(d)[0], d)
    n = sd.state.n_local
    r = sd.state.r[:n].numpy()
    L = sd.box.lengths.numpy().astype(np.float64)
    rc, sk = sd.rcut_max, sd.neighbor_deltaR
    walls = orcb_walls(r, L, SHAPE, min_frac=tuple(1.05 * (rc + sk) / L))
    jcp = jps.plan_shard_cells(L, SHAPE, rc, sk, n, walls=walls)
    tcp = sc.plan_shard_cells(L, SHAPE, rc, sk, n, walls=walls)
    Lj = jnp.asarray(L, jnp.float32)
    Lt = torch.tensor(L, dtype=torch.float32)
    rt = torch.tensor(r)
    j_core, t_core = np.zeros(n, int), np.zeros(n, int)
    nc = np.asarray(tcp.ncore)
    for idx3 in np.ndindex(*SHAPE):
        ji = tuple(jnp.asarray(i, jnp.int32) for i in idx3)
        u = np.asarray(jps.brick_frame_frac(jnp.asarray(r), Lj, jcp, ji))
        j_core += np.all(np.floor((u + 0.5) * nc) == np.clip(
            np.floor((u + 0.5) * nc), 0, nc - 1), axis=1)
        ut = sc.bin_frac(sc.brick_frame_frac(rt, Lt, tcp, sc.dev_geom(
            tcp, idx3, "cpu")), rt, Lt, tcp, idx3).numpy()
        t_core += np.all((ut >= -0.5) & (ut < 0.5), axis=1)
    assert (j_core != 1).sum() > 0
    assert (t_core == 1).all()
