"""Triclinic bricks (BOX type=GENERAL) on the mesh's list engine over gloo
ranks, against the JAX package.

Ports tests/test_brick_triclinic.py: the dry run's synthetic system with
its b vector tilted by 0.25 L (same fractions, same density) at (2,2,2)
-- first forces against the JAX single-device list in f32 and against
the JAX brick engine (make_brick_step) by gid in f64, a step and a
migration -- then the GENERAL PAIR deck through ParallelSimulation
against the JAX ParallelSimulation, its checkpoint restarted under
Simulation and under the mesh, ZRAMP walls and VORONOI centres on a
tilted deck against the JAX decomposition, and the Berendsen NPT deck at
(1,1,2) against the JAX mesh's box.  A row past the seam of an axis of
eight bricks keeps its pairs (held to the single-device list: the JAX
brick engine drops them, ROADMAP section 3).  One spawn of eight ranks
and one of two check everything.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
from ddcmd_tpu.nbr.celllist import CellGrid as JCellGrid
from ddcmd_tpu.nbr.celllist import build_neighbor_list as j_build
from ddcmd_tpu.potentials.martini import martini_nonbond as j_martini
from ddcmd_tpu.run.cli import load_db as j_load_db
from ddcmd_tpu.run.parallel_sim import ParallelSimulation as JParallel

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

TILT = 0.25
SKIN = 0.15
TABLE_KEYS = ("sigma", "eps", "shift", "rcut2", "krf", "crf", "keR")


def _perp(h):
    return 1.0 / np.linalg.norm(np.linalg.inv(h), axis=1)


def general_deck(d, tilt=0.2, seed=5, npt=False, warp=0.0, lb=None, m=6):
    """The JAX test's GENERAL PAIR deck (tests/test_brick_triclinic.py:
    140, 218): 216 argon atoms on a jittered 6^3 lattice (m = 6) in a
    2.4 nm box (0.4 nm a lattice site) whose b vector is tilted by `tilt`
    L; NGLF with a FREE group (the
    JAX mesh runs the test's NVEGLF as NGLF, the port's refuses it), or
    with `npt` the Berendsen NGLFCONSTRAINT deck.  warp: the fractions
    s_x, s_y moved by warp sin(2 pi s) / (2 pi), a density that varies
    along x and y; lb: a LOADBALANCE type on the DDC object."""
    L = 4.0 * m
    h = np.diag([L, L, L])
    h[0, 1] = tilt * L
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    s = (g + 0.5) / m - 0.5 + (rng.random((m ** 3, 3)) - 0.5) * 0.02
    s[:, :2] += warp * np.sin(2 * np.pi * s[:, :2]) / (2 * np.pi)
    r = s @ h.T
    n = len(r)
    v = rng.standard_normal((n, 3)) * (0.004 if npt else 0.002)
    rows = [f"{i} ATOM Ar free " + " ".join("%.8f" % x for x in r[i])
            + " " + " ".join("%.8f" % x for x in v[i]) for i in range(n)]
    hflat = " ".join("%.6f" % x for x in h.reshape(-1))
    hdr = (f"particle FILEHEADER {{type=MULTILINE; datatype=VARRECORDASCII;"
           f" checksum=NONE;\nloop=0; time=0.0;\nnfiles=1; nrecord={n};"
           f" nfields=10;\nfield_names=id class type group rx ry rz vx vy "
           f"vz;\nfield_types=u s s s f f f f f f;\nh= {hflat} ;\n}}\n\n")
    with open(os.path.join(d, "atoms#000000"), "w") as f:
        f.write(hdr + "\n".join(rows) + "\n")
    integ = ("INTEGRATOR { type=NGLFCONSTRAINT; T=120K; P0=1.0 bar; "
             "beta=3.0e-4 /bar; tauBarostat=1.0 ps; isotropic=1; }" if npt
             else "INTEGRATOR { type=NGLF; }")
    ddc = ("ddc DDC { updateRate=10; }" if lb is None else
           "ddc DDC { updateRate=10; loadBalance=bal; }\n"
           f"bal LOADBALANCE {{ type={lb}; }}")
    deck = f"""
simulate SIMULATE {{ type=MD; system=system; integrator=integ; dt=4;
  maxloop=1000; printrate=50; ddc=ddc; }}
{ddc}
pot POTENTIAL {{ type=PAIR; cutoff=7.0 Angstrom; eps=0.01 eV;
  sigma=3.4 Angstrom; }}
integ {integ}
system SYSTEM {{ type=NORMAL; potential=pot; neighbor=nbr; groups=free;
  box=box; collection=collection; species=Ar; }}
Ar SPECIES {{ type=ATOM; mass=39.948; charge=0; }}
box BOX {{ type=GENERAL; pbc=7; h= {hflat} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=1.2; }}
free GROUP {{ type=FREE; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""
    with open(os.path.join(d, "object.data"), "w") as f:
        f.write(deck)
    return d


def _spec():
    """The dry run's system for 8 devices (L = 6.4 nm, 13^3 particles,
    rcut 0.6 nm) sheared to tilt 0.25, and the row of the largest x
    fraction moved 0.05 nm past the +x seam (x_new)."""
    L = 6.4
    n = int(np.ceil(L / 0.5)) ** 3
    arrays, L, rcut, tables = graft._synthetic_system(n=n, L=L, rcut=0.6,
                                                      sigma0=0.4)
    h = np.diag([L, L, L])
    h[0, 1] = TILT * L
    spec = {k: np.asarray(v) for k, v in arrays.items()}
    spec["r"] = (spec["r"] / L) @ h.T
    spec["gid"] = np.arange(n, dtype=np.int64)
    spec.update({k: np.asarray(tables[k], np.float64) for k in TABLE_KEYS})
    s = spec["r"] @ np.linalg.inv(h).T
    k = int(np.argmax(s[:, 0]))
    assert s[k, 0] > 0.5 - 1.0 / 8
    spec.update(L=L, h=h, rcut=rcut, skin=SKIN, seam_gid=k,
                seam_x=-0.5 * L + 0.05 + TILT * spec["r"][k, 1])
    return spec


def _jax_list(r, spec, dtype):
    """The JAX package's single-device list evaluation (one jit): (e, f)."""
    h, n = spec["h"], len(r)
    grid = JCellGrid.plan(_perp(h), float(spec["rcut"]), SKIN, n, n)
    tables = {k: jnp.asarray(spec[k], dtype) for k in TABLE_KEYS}

    @jax.jit
    def run(rj, hj, q, species):
        ones = jnp.ones(n, dtype)
        nbr, _, ov = j_build(rj, ones, hj, grid)
        f, e, *_ = j_martini(rj, q, species, ones, nbr, hj, tables)
        return f, e, ov

    f, e, ov = run(jnp.asarray(r, dtype), jnp.asarray(h, dtype),
                   jnp.asarray(spec["q"], dtype), jnp.asarray(spec["species"]))
    assert not bool(ov)
    return float(e), np.asarray(f, np.float64)


def _jax_brick_forces(spec, shape, move=None):
    """The JAX brick engine (make_brick_step) on the tilted system in f64
    at `shape`, `move` (gid, x) applied after the distribution: (e,
    forces by gid)."""
    from ddcmd_tpu.core.groups import Group, GroupTable
    from ddcmd_tpu.parallel.brick import BrickPlan, distribute_bricks
    from ddcmd_tpu.parallel.brickstep import make_brick_mesh, make_brick_step

    f64 = jnp.float64
    h, n = spec["h"], len(spec["r"])
    n_dev = int(np.prod(shape))
    plan = BrickPlan(shape=shape, local_cap=8 * n // n_dev,
                     halo_cap=4 * n // n_dev, migrate_cap=256,
                     rlist=float(spec["rcut"]) + SKIN)
    grid = JCellGrid.plan(_perp(h), float(spec["rcut"]), SKIN, n,
                          plan.local_cap + plan.ghost_cap)
    mesh = make_brick_mesh(shape)
    coeffs = GroupTable.build([Group(name="free", index=0, type="FREE")]
                              ).coefficients(0.0, 0.01, dtype=f64)
    _, first, _ = make_brick_step(
        mesh, plan, grid, {k: jnp.asarray(spec[k], f64) for k in TABLE_KEYS},
        coeffs, dt=0.02, box_lengths=h,
        species_lj_type=np.array([0, 1], np.int32), n_global=n)
    g = spec["gid"]
    arrays = {k: np.asarray(spec[k], np.float64)
              for k in ("r", "v", "q", "mass")}
    arrays.update(species=spec["species"], group=spec["group"],
                  gid=np.stack([g.astype(np.uint32), (g >> 32).astype(
                      np.uint32)], axis=1))
    buf, mask, _ = distribute_bricks(arrays, h, plan)
    gb = buf["gid"][:, 0].astype(np.int64)
    if move is not None:
        buf["r"][mask & (gb == move[0]), 0] = move[1]
    shard = lambda a: jax.device_put(                        # noqa: E731
        jnp.asarray(a), NamedSharding(mesh, P(("bx", "by", "bz"))))
    f, e, _, ov = first({k: shard(v) for k, v in buf.items()}, shard(mask),
                        jax.random.PRNGKey(0))
    assert not int(ov)
    out = np.zeros((n, 3))
    out[gb[mask]] = np.asarray(f)[mask]
    return float(e), out


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """One spawn of eight gloo ranks (torch_mesh_ranks.triclinic_mesh):
    (its npz, the spec, the deck directories)."""
    tmp = tmp_path_factory.mktemp("tri8")
    spec = _spec()
    p = str(tmp / "spec.npz")
    np.savez(p, **spec)
    decks = {}
    # the balanced decks at m = 8 (3.2 nm): bricks wide enough beside
    # rlist (0.82 nm) for the Voronoi centres to move
    for kind, kw in (("pair", {}),
                     ("zramp", dict(warp=0.2, lb="ZRAMP", m=8)),
                     ("voronoi", dict(warp=0.2, lb="VORONOI", m=8))):
        d = tmp / kind
        d.mkdir()
        decks[kind] = general_deck(str(d), **kw)
    out = str(tmp / "out.npz")
    ranks.run_ranks(ranks.triclinic_mesh, 8, tmp, p, decks, out)
    return dict(np.load(out)), spec, decks


def _sim_first(d, restart=None):
    """The port's Simulation in f64 on a deck: (e, f)."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation

    sim = Simulation(*load(d, restart=restart), run_dir=d, device="cpu",
                     dtype=torch.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    return float(sim.ss.energy.eion), sim.ss.state.f[:n].numpy()


def _close(e, f, e_ref, f_ref, tol):
    assert abs(float(e) - e_ref) <= tol * abs(e_ref)
    assert np.abs(f - f_ref).max() <= tol * np.abs(f_ref).max()


def test_tilted_bricks_f32_against_jax_list(eight):
    """(2,2,2) in f32: first energy within 1e-4 relative of the JAX
    single-device list (the dry run's gate), forces by gid within 2e-5
    of the scale."""
    z, spec, _ = eight
    e_ref, f_ref = _jax_list(spec["r"], spec, jnp.float32)
    assert not z["f32_ov"]
    assert abs(float(z["f32_e"]) - e_ref) <= 1e-4 * abs(e_ref)
    assert np.abs(z["f32_f"] - f_ref).max() <= 2e-5 * np.abs(f_ref).max()


def test_tilted_bricks_f64_against_jax_mesh(eight):
    """(2,2,2) in f64: first energy and forces by gid within 1e-8 of the
    JAX brick engine on the same bricks."""
    z, spec, _ = eight
    assert not z["f64_ov"]
    _close(z["f64_e"], z["f64_f"], *_jax_brick_forces(spec, (2, 2, 2)), 1e-8)


@pytest.mark.parametrize("leg", ["f32", "f64"])
def test_tilted_step_and_migration(eight, leg):
    """A step and a staged migration in the tilted box: no overflow, the
    forces finite, every gid owned once after it."""
    z, spec, _ = eight
    assert not (z[f"{leg}_ov_s"] or z[f"{leg}_ov_m"])
    assert bool(z[f"{leg}_finite"])
    assert sorted(z[f"{leg}_gids"].tolist()) == spec["gid"].tolist()


def test_tilted_seam_row_keeps_its_pairs(eight):
    """(8,1,1) in f64, a row of the last brick moved 0.05 nm past the +x
    seam since the last migration (still owned there): the windows,
    measured from each brick's centre in the fraction, ship it to brick
    0, and the first energy and forces equal the single-device list of
    the same positions (1e-10).  The JAX brick engine compares the raw
    fraction, ships the row to brick 6 and drops brick 0's pairs with
    it (ROADMAP section 3)."""
    z, spec, _ = eight
    k, x_new = int(spec["seam_gid"]), float(spec["seam_x"])
    moved = spec["r"].copy()
    moved[k, 0] = x_new
    e_ref, f_ref = _jax_list(moved, spec, jnp.float64)
    assert not z["seam_ov"]
    _close(z["seam_e"], z["seam_f"], e_ref, f_ref, 1e-10)
    je, jf = _jax_brick_forces(spec, (8, 1, 1), (k, x_new))
    assert abs(je - e_ref) > 1e-4 * abs(e_ref)
    assert np.abs(jf.sum(axis=0)).max() > 1e-3 * np.abs(f_ref).max()


def test_general_pair_deck_against_jax_mesh(eight):
    """The GENERAL PAIR deck at (2,2,2) in f64 on the list engine: first
    energy and forces by gid within 1e-8 of the JAX ParallelSimulation;
    two chunks keep every particle and finite forces."""
    z, _, decks = eight
    d = decks["pair"]
    jps = JParallel(j_load_db([os.path.join(d, "object.data")], None, d), d,
                    shape=(2, 2, 2), dtype=jnp.float64)
    je = jps.first_energy()
    m = np.asarray(jps.mask)
    jf = np.zeros((216, 3))
    jf[np.asarray(jps.fields["gid"])[m][:, 0].astype(np.int64)] = \
        np.asarray(jps.f)[m]
    assert str(z["pair_engine"]) == "nlist"
    _close(z["pair_e"], z["pair_f"], je, jf, 1e-8)
    assert int(z["pair_loop"]) == 20 and bool(z["pair_finite"])
    assert sorted(z["pair_gids"].tolist()) == list(range(216))


def test_general_checkpoint_restarts(eight):
    """The mesh's checkpoint of the GENERAL deck keeps the tilted h: the
    mesh restarted from it reads the same h and first energy as the
    mesh that wrote it, and Simulation restarted from it the same
    first energy (f64)."""
    z, _, decks = eight
    d = decks["pair"]
    np.testing.assert_allclose(z["pair_restart_h"], z["pair_h"], rtol=1e-12)
    assert z["pair_h"][0, 1] != 0.0
    e1 = float(z["pair_e1"])
    assert abs(float(z["pair_restart_e"]) - e1) <= 1e-9 * abs(e1)
    e_sim, _ = _sim_first(d, restart=os.path.join(d, "restart"))
    assert abs(e_sim - e1) <= 1e-9 * abs(e1)


def _jax_decomposition(d):
    """The JAX ParallelSimulation on a deck at (2,2,2) in f64, and each
    particle's owner (its brick) by gid."""
    jps = JParallel(j_load_db([os.path.join(d, "object.data")], None, d), d,
                    shape=(2, 2, 2), dtype=jnp.float64)
    m = np.asarray(jps.mask)
    g = np.asarray(jps.fields["gid"])[:, 0].astype(np.int64)
    owner = np.zeros(len(g[m]), np.int64)
    owner[g[m]] = np.nonzero(m)[0] // jps.plan.local_cap
    return jps, owner


def test_zramp_walls_on_tilted_deck(eight):
    """ZRAMP on the tilted deck with a density varying along x and y: the
    walls, computed in the frame r h^-T L, equal the JAX package's
    (1e-12), every particle sits on the JAX package's brick, first
    energy and forces within 1e-8 of Simulation's (f64), and two chunks
    keep every particle."""
    z, _, decks = eight
    jps, owner = _jax_decomposition(decks["zramp"])
    plan = jps.plan
    for a in range(3):
        np.testing.assert_allclose(z[f"zramp_w{a}"], plan.walls[a],
                                   rtol=0, atol=1e-12)
    assert not np.allclose(z["zramp_w0"], [0.0, 0.5, 1.0])
    np.testing.assert_array_equal(z["zramp_owner"], owner)
    _close(z["zramp_e"], z["zramp_f"], *_sim_first(decks["zramp"]), 1e-8)
    assert bool(z["zramp_finite"])
    assert sorted(z["zramp_gids"].tolist()) == list(range(512))


def test_voronoi_on_tilted_deck(eight):
    """VORONOI on the same tilted deck: the starting centres (the brick
    centres in the scaled-fractional frame) and every particle's owner
    equal the JAX package's; after one balance_step, on the positions
    of that frame, the centres moved, and the first energy and forces
    equal Simulation's on the gathered state within 1e-8 (f64); two
    chunks of migration by the nearest centre keep every particle.  The
    JAX mesh dies at its first chunk's migration: its containment check
    takes the minimum image against the (3, 3) h as if it were lengths
    (ROADMAP section 3)."""
    z, _, decks = eight
    jps, owner = _jax_decomposition(decks["voronoi"])
    plan = jps.plan
    np.testing.assert_allclose(z["voronoi_centers"],
                               plan.voronoi["centers"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(z["voronoi_owner"], owner)
    assert np.abs(z["voronoi_centers_rb"] - z["voronoi_centers"]).max() > 0
    _close(z["voronoi_e"], z["voronoi_f"], *_sim_first(decks["voronoi"]),
           1e-8)
    assert bool(z["voronoi_finite"])
    assert sorted(z["voronoi_gids"].tolist()) == list(range(512))
    jps.first_energy()
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jps.run(10, print_fn=lambda s: None)


def test_triclinic_npt_against_jax_mesh(tmp_path):
    """The GENERAL Berendsen deck (tilt 0.15) at (1,1,2) in f64, 20 steps
    (two chunks): the live h equals the JAX mesh's after the same steps
    (1e-10), the tilt ratio h01 / h00 stays 0.15 (1e-12), the volume
    moved, every particle kept."""
    d = general_deck(str(tmp_path), tilt=0.15, seed=9, npt=True)
    out = str(tmp_path / "npt.npz")
    ranks.run_ranks(ranks.triclinic_npt, 2, tmp_path, d, (1, 1, 2), 20, out)
    z = np.load(out)
    jps = JParallel(j_load_db([os.path.join(d, "object.data")], None, d), d,
                    shape=(1, 1, 2), dtype=jnp.float64)
    jps.first_energy()
    jps.run(20, print_fn=lambda s: None)
    jh = np.asarray(jps.Lv, np.float64)
    h = z["h"]
    assert bool(z["barostat"]) and str(z["engine"]) == "nlist"
    np.testing.assert_allclose(h, jh, rtol=0, atol=1e-10 * jh[0, 0])
    assert h[0, 1] / h[0, 0] == pytest.approx(0.15, rel=1e-12)
    assert abs(np.linalg.det(h) / 24.0 ** 3 - 1.0) > 1e-6
    assert sorted(z["gids"].tolist()) == list(range(216))


def test_forced_pallas_raises_on_triclinic(tmp_path, monkeypatch):
    """The engine pick sends a triclinic deck to the list engine naming
    the box; DDCMD_SHARD_ENGINE=pallas on it raises ValueError, as the
    JAX pick does (parallel_sim.py:647-683 there)."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    d = general_deck(str(tmp_path))
    monkeypatch.setenv("DDCMD_SHARD_ENGINE", "pallas")
    with pytest.raises(ValueError, match="pallas infeasible: a triclinic box"):
        ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu")


@pytest.mark.parametrize("deck", ["bilayer", "eam"])
def test_tilted_decks_at_one_brick(tmp_path, deck):
    """The mesh's other triclinic paths at (1,1,1) in f64 against
    Simulation (cell-block engines, f64): the small bilayer tilted by 0.2
    L (bonds, angles, RATTLE groups, exclusions masked by gid, the
    semi-anisotropic Berendsen move h' = diag(lam) h) and the monoclinic
    EAM crystal (both EAM passes with the full vector's minimum image):
    first energy and forces within 1e-10, then four steps with finite
    forces and every particle kept."""
    import chip_smoke
    from ddcmd_tpu_torch.models import load, martini_bilayer
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    d = str(tmp_path)
    if deck == "bilayer":
        martini_bilayer(d, nx=4, ny=4, water_nm=1.2)
        chip_smoke.tilt_deck(d, 0.2)
    else:
        chip_smoke.triclinic_eam_deck(d, 4, 100)
    f64 = torch.float64
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device="cpu",
                            dtype=f64)
    assert ps.shard_engine == "nlist" and ps.Lv.shape == (3, 3)
    assert (ps.barostat is not None) == (deck == "bilayer")
    e = ps.first_energy()
    f = ps.gather_by_gid(("f",))["f"]
    e_ref, f_ref = _sim_first(d)
    _close(e, f, e_ref, f_ref, 1e-10)
    h0 = ps.Lv.clone()
    ps.run(4)
    assert ps.loop == 4 and int(ps.mask.sum()) == len(f_ref)
    assert bool(torch.isfinite(ps.f[ps.mask]).all())
    assert (deck == "eam") == bool(torch.equal(ps.Lv, h0))
