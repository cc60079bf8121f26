"""VORONOI domains on a covalent NPT deck: the nx = 8 Martini bilayer
(2,888 beads; bonds, angles, RATTLE, exclusions, semi-anisotropic
Berendsen NPT) at (2,2,2) over 8 gloo ranks in f64, against the JAX
package's f64 Simulation on its list engine.

Molecule-coherent migration routes each lipid by its head bead's nearest
centre; the centres scale with the live box; the exclusions are masked
in the list by gid.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import martini_bilayer

import torch_mesh_ranks as ranks

torch.set_num_threads(2)


def test_voronoi_bilayer_npt_f64(tmp_path):
    """After one rebalance the (2,2,2) VORONOI mesh's f64 first energy
    and forces equal the JAX package's f64 Simulation (1e-10 relative,
    1e-10 of the force scale); two NPT chunks (one more rebalance, at
    rate 12) keep every bead, their forces finite."""
    d = str(tmp_path)
    martini_bilayer(d, nx=8, ny=8)
    ranks.set_loadbalance(d, "VORONOI", rate=12, update_rate=12)
    sim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                      dtype=jnp.float64)
    sim.first_energy()
    n = sim.sysdef.state.n_local
    f0 = np.asarray(sim.ss.state.f[:n], np.float64)
    e0 = float(sim.ss.energy.eion)
    out = str(tmp_path / "v.npz")
    ranks.run_ranks(ranks.mesh_forces, 8, tmp_path, d, (2, 2, 2), out, None,
                    "float64", 24, True)
    z = np.load(out)
    assert str(z["engine"]) == "nlist" and not bool(z["ov"])
    assert float(z["e"]) == pytest.approx(e0, rel=1e-10)
    assert np.abs(z["f"] - f0).max() <= 1e-10 * np.abs(f0).max()
    assert int(z["loop"]) == 24 and int(z["n_rebalance"]) == 2
    assert bool(z["finite"]) and sorted(z["gids"].tolist()) == sorted(
        np.asarray(sim.sysdef.collection.gid, np.int64).tolist())
