"""The Martini bilayer under the port's brick mesh (bonded terms, RATTLE,
in-kernel exclusions, semi-anisotropic Berendsen NPT) against the JAX
package's single-device run.

The nx = 8 bilayer (2,888 beads) over gloo in spawned ranks (tests/
torch_mesh_ranks.py) at (2,2,2), the JAX package's multichip dry-run
leg, and at (2,2,1) for first forces only; in-process at (1,1,1).
First energy and forces are held to the JAX package's single-device
(N,K)-list evaluation in float64 at the tolerances of
tests/test_pallas_shard.py (energy rel 1e-5, forces 2e-5 of the scale),
computed once for the module; at (2,2,2) one NPT chunk then keeps every
molecule on one rank and every particle, holds the constraints, and
scales the box as integrators/nglf.barostat_scale does on the same
virial.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load, martini_bilayer
from ddcmd_tpu_torch.ops import cellpair_half as ch
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
from ddcmd_tpu_torch.run.simulate import Simulation

import torch_mesh_ranks as ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """The nx = 8 bilayer: its (2,2,*) bricks clear 2 rlist (3.2 of
    1.4 nm)."""
    d = str(tmp_path_factory.mktemp("bilayer8"))
    martini_bilayer(d, nx=8, ny=8)
    return d


@functools.lru_cache(maxsize=None)
def _jax_ref(d):
    """(e, f (n, 3) in collection order) of the JAX package's
    single-device (N,K)-list first energy in float64."""
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    return (float(sim.ss.energy.eion),
            np.asarray(sim.ss.state.f[:n], np.float64))


def _assert_first(e, f, d):
    e_ref, f_ref = _jax_ref(d)
    assert e == pytest.approx(e_ref, rel=1e-5)
    scale = max(1.0, float(np.abs(f_ref).max()))
    assert float(np.abs(f - f_ref).max()) <= 2e-5 * scale


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 2, 1)])
def test_bilayer_ranks_first_forces_and_npt_chunk(tmp_path, deck, shape):
    """Over gloo: first energy and forces match the JAX package.  At
    (2,2,2), the dry run's leg, also: one NPT step scales the box exactly
    as barostat_scale on the same virial; one NPT chunk with migration
    keeps all 2,888 particles once, every molecule (head gid) on one
    rank, and the RATTLE residual < 5e-3."""
    out = str(tmp_path / "bl.npz")
    npt = shape == (2, 2, 2)
    ranks.run_ranks(ranks.bilayer_npt, int(np.prod(shape)), tmp_path, deck,
                    shape, out, npt)
    z = np.load(out)
    assert bool(z["excl"]) and bool(z["npt"])
    _assert_first(float(z["e"]), z["f"], deck)
    if not npt:
        return
    assert not bool(z["ov1"])
    np.testing.assert_allclose(z["L1"], z["L1_ref"], rtol=1e-6)
    assert int(z["loop"]) == int(z["chunk"]) and bool(z["finite"])
    gids, hgids, where = z["gids"], z["hgids"], z["where"]
    assert len(gids) == len(np.unique(gids)) == 2888
    for h in np.unique(hgids):
        assert len(np.unique(where[hgids == h])) == 1, h
    assert float(z["resid"]) < 5e-3
    assert np.isfinite(z["L"]).all() and not np.allclose(z["L"], z["L1"])


def test_bilayer_single_brick_matches_simulation(deck):
    """(1,1,1) in-process: the mesh's first energy, forces and molecular
    virial diagonal equal the single-device Simulation's; a superchunk
    and a remainder chunk with exclusions go through the extended-grid
    wrapper only (the CPU runs its plain version), and the printed rows
    carry P and V."""
    ps = ParallelSimulation(*load(deck), shape=(1, 1, 1), device="cpu")
    sim = Simulation(*load(deck), run_dir=deck, device="cpu")
    sim.first_energy()
    n = ps.sysdef.state.n_local
    e = ps.first_energy()
    assert e == pytest.approx(float(sim.ss.energy.eion), rel=2e-6)
    f1 = sim.ss.state.f[:n].numpy()
    scale = max(1.0, float(np.abs(f1).max()))
    assert np.abs(ps.gather_by_gid(("f",))["f"] - f1).max() <= 2e-5 * scale
    vd = torch.diagonal(sim.mol_virial_fn(sim.ss.state, sim.ss.box,
                                          sim.ss.energy.virial))
    np.testing.assert_allclose(ps.vird.numpy(), vd.numpy(), rtol=1e-4,
                               atol=1.0)
    before = (ch.cellpair_half_ext.launches, ch.cellpair_half.launches)
    lines = []
    ps.sysdef.cfg.printrate = 1
    k = ps.chunk_steps
    # one superchunk of two NPT chunks, then a 3-step NPT remainder
    ps.run(2 * k + 3, print_fn=lines.append, max_steps_per_dispatch=2 * k)
    assert (ch.cellpair_half_ext.launches, ch.cellpair_half.launches) \
        == before                           # CPU: plain versions only
    assert ps.loop == 2 * k + 3 and int(ps.mask.sum()) == n
    assert len(lines) == 2 * k + 3 and " P=" in lines[-1]
    T = float(lines[-1].split("T=")[1].split()[0])
    assert 200.0 < T < 500.0
