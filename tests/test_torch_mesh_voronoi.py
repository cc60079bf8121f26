"""VORONOI load balance under the port's mesh (parallel/voronoi.py, the
Voronoi plan of parallel/brick.py, the list engine) over 8 gloo ranks,
against the JAX package.

The deck is tests/torch_mesh_ranks.skewed_water at n = 4000 (3,025
beads, 8.1 nm): its density varies by x and y slab, so one balance_step
moves the (2,2,2) centres well off the brick centres.  The host half of
parallel/voronoi.py is held to the JAX package's on the deck's
positions; the mesh's first forces after one rebalance to the JAX
package's f64 Simulation at the walls' 4e-5 of the force scale
(tests/test_torch_mesh_walls.py); each rank's halo to the particles
within rlist of its domain; a rebalance at `rate`; the centres through a
checkpoint's pxyz into both packages' meshes.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.parallel import voronoi as jv
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.pxyz import read_pxyz_full
from ddcmd_tpu_torch.parallel import voronoi as tv

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

SHAPE = (2, 2, 2)
RLIST = 1.5                      # nm: 11 A rmax + 4 A deltaR
F_TOL, E_TOL = 4e-5, 2e-5


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """The skewed deck under VORONOI (updateRate 2, rate 2), the JAX
    package's f64 first energy and forces, and the f32 start positions
    both packages' meshes balance from."""
    d = str(tmp_path_factory.mktemp("vor"))
    ranks.skewed_water(d, n=4000)
    ranks.set_loadbalance(d, "VORONOI", rate=2, update_rate=2)
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    sd = j_build_system(j_load(d)[0], d, dtype=jnp.float32)
    L = np.asarray(sd.box.lengths, np.float64)
    return dict(d=d, n=n, L=L, e=float(sim.ss.energy.eion),
                f=np.asarray(sim.ss.state.f[:n], np.float64),
                r=np.asarray(sd.state.r[:n], np.float64))


@pytest.fixture(scope="module")
def eight(deck, tmp_path_factory):
    """One spawn of eight gloo ranks (torch_mesh_ranks.run_legs) for the
    mesh tests below: the first forces after one rebalance, the halo
    after one rebalance, six steps at rate 2 (all on the deck), and on a
    fresh copy of it the checkpoint after one rebalance and the mesh
    restarted from it.  {leg: the npz path (prefix) it wrote}."""
    tmp = tmp_path_factory.mktemp("vor8")
    ck = str(tmp / "deck")
    os.makedirs(ck)
    ranks.skewed_water(ck, n=4000)
    ranks.set_loadbalance(ck, "VORONOI", rate=2, update_rate=2)
    out = {k: str(tmp / f"{k}.npz") for k in ("ff", "run", "ck", "rs")}
    out.update(halo=str(tmp / "halo"), ck_dir=ck)
    d = deck["d"]
    ranks.run_ranks(ranks.run_legs, 8, tmp, (
        ("mesh_forces", (d, SHAPE, out["ff"], None, "float32", 0, True)),
        ("voronoi_halo", (d, SHAPE, out["halo"])),
        ("mesh_forces", (d, SHAPE, out["run"], None, "float32", 6)),
        ("voronoi_checkpoint", (ck, SHAPE, ck, out["ck"])),
        ("voronoi_checkpoint", (ck, SHAPE, ck, out["rs"],
                                os.path.join(ck, "restart")))))
    return out


def test_host_functions_equal_jax(deck):
    """assign_host, face_margins, clamp_centers and balance_step of the
    port equal the JAX package's on the deck's positions, bit for bit,
    from the nominal centres and from centres pushed off them."""
    r, L = deck["r"], deck["L"]
    c0 = tv.nominal_centers(L, SHAPE)
    np.testing.assert_array_equal(c0, jv.nominal_centers(L, SHAPE))
    assert tv.beta_max(L, SHAPE) == jv.beta_max(L, SHAPE)
    off = c0 + np.random.default_rng(2).uniform(-0.6, 0.6, c0.shape)
    for c in (c0, off):
        np.testing.assert_array_equal(tv.assign_host(r, c, L, SHAPE),
                                      jv.assign_host(r, c, L, SHAPE))
        np.testing.assert_array_equal(tv.face_margins(c, L, SHAPE),
                                      jv.face_margins(c, L, SHAPE))
        for a, b in zip(tv.clamp_centers(c, L, SHAPE, RLIST),
                        jv.clamp_centers(c, L, SHAPE, RLIST)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tv.balance_step(c0, r, L, SHAPE, RLIST),
                    jv.balance_step(c0, r, L, SHAPE, RLIST)):
        np.testing.assert_array_equal(a, b)


def test_voronoi_first_forces_match_jax(deck, eight):
    """After one rebalance (one balance_step from the brick centres) the
    centres and margins are the JAX package's from the same positions,
    the mesh runs the list engine, and its first energy and forces match
    the JAX package's f64 Simulation (energy 2e-5 relative, forces 4e-5
    of the scale)."""
    z = np.load(eight["ff"])
    assert str(z["engine"]) == "nlist" and not bool(z["ov"])
    c, m = jv.balance_step(jv.nominal_centers(deck["L"], SHAPE), deck["r"],
                           deck["L"], SHAPE, RLIST)
    np.testing.assert_array_equal(z["centers"], c)
    np.testing.assert_array_equal(z["margins"], m)
    assert np.abs(c - jv.nominal_centers(deck["L"], SHAPE)).max() > 0.1
    assert float(z["e"]) == pytest.approx(deck["e"], rel=E_TOL)
    scale = max(1.0, float(np.abs(deck["f"]).max()))
    assert float(np.abs(z["f"] - deck["f"]).max()) <= F_TOL * scale


def test_voronoi_halo_complete(deck, eight):
    """Each rank's ghosts hold every particle within rlist of a particle
    it owns (its Voronoi domain's neighbours), and lie within the window
    of rlist plus each axis's margin about its nominal brick."""
    out = eight["halo"]
    z = np.load(out + ".npz")
    r, L, margins = z["r"], z["L"], z["margins"]
    owner = tv.assign_host(r, z["centers"], L, SHAPE)
    for rank in range(8):
        h = np.load(f"{out}_{rank}.npz")
        assert not bool(h["ov"])
        own = h["own"]
        np.testing.assert_array_equal(np.sort(own),
                                      np.nonzero(owner == rank)[0])
        d = r[:, None, :] - r[own][None, :, :]
        d -= L * np.round(d / L)
        near = (np.sum(d * d, -1) < RLIST ** 2).any(axis=1)
        need = set(np.nonzero(near & (owner != rank))[0].tolist())
        ghost = h["ghost"]
        assert need <= set(ghost.tolist())
        i3 = np.unravel_index(rank, SHAPE)
        for a in range(3):
            lo = (i3[a] / SHAPE[a] - 0.5) * L[a]
            x = r[ghost, a] - (lo + 0.5 * L[a] / SHAPE[a])
            x -= L[a] * np.round(x / L[a])
            assert np.all(np.abs(x) < 0.5 * L[a] / SHAPE[a] + RLIST
                          + margins[a] + 1e-6)


def test_voronoi_rebalance_at_rate(deck, eight):
    """At rate 2 with updateRate 2, six steps rebalance at loops 2 and 4;
    every particle stays owned once and the forces stay finite."""
    z = np.load(eight["run"])
    assert int(z["n_rebalance"]) == 2 and int(z["loop"]) == 6
    assert bool(z["finite"])
    assert sorted(z["gids"].tolist()) == list(range(deck["n"]))


def test_voronoi_pxyz_restart_both_meshes(eight):
    """A checkpoint after one rebalance writes the centres into its pxyz;
    the port's mesh restarted from it resumes them (its first energy the
    checkpointed mesh's), and so does the JAX package's mesh."""
    from ddcmd_tpu.run.parallel_sim import \
        ParallelSimulation as JParallelSimulation

    d = eight["ck_dir"]
    z = np.load(eight["ck"])
    saved = read_pxyz_full(os.path.join(str(z["snap"]), "pxyz"))
    assert saved["lb"] == "voronoi"
    c = np.asarray(saved["voronoi"]["centers"]).reshape(z["centers"].shape)
    # the pxyz writes centres as %.8f in Angstrom: 5e-10 nm
    np.testing.assert_allclose(c, z["centers"], rtol=0, atol=1e-9)
    restart = os.path.join(d, "restart")
    rz = np.load(eight["rs"])
    np.testing.assert_array_equal(rz["centers"], c)
    assert float(rz["e"]) == pytest.approx(float(z["e"]), rel=1e-6)
    jps = JParallelSimulation(*j_load(d, restart=restart), shape=SHAPE)
    np.testing.assert_array_equal(np.asarray(jps.plan.voronoi["centers"]), c)
