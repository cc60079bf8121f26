"""The NVE reads that chip_smoke.py's phase 19(b) holds (C) to: the c36
solvated tripeptide at full size (chip_smoke.charmm_tripeptide_deck, L =
40 A, 1,200 TIP3 waters, 3,630 atoms, FREE, dt 0.25 fs) from rest in f64.
Its total energy swings by kJ/mol from read to read while the strained
start relaxes, so the card's run is held read by read to the JAX
package's own run of the same deck, chip_smoke.C36_NVE_JAX. This test
recomputes those reads with ddcmd_tpu's Simulation(engine="nlist") on
the CPU and holds the constant to them within 1e-7 kJ/mol (the constant
keeps 13 decimals; the card's gate, C36_NVE_BAND, is 1e-3).
"""

import numpy as np
import jax.numpy as jnp

import chip_smoke

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSim


def test_c36_nve_reads_equal_jax(tmp_path):
    d = str(tmp_path)
    chip_smoke.charmm_tripeptide_deck(d, chip_smoke.C36_L,
                                      chip_smoke.C36_MAX_W, nve=True,
                                      dt_fs=chip_smoke.C36_NVE_DT)
    sim = JSim(*j_load(d), run_dir=d, dtype=jnp.float64, engine="nlist")
    assert sim.sysdef.state.n_local == 3630
    sim.first_energy()
    e0 = float(sim.ss.energy.eion + sim.ss.energy.rk)
    reads = []
    for _ in chip_smoke.C36_NVE_JAX:
        sim.run(chip_smoke.C36_NVE_CHUNK, print_fn=lambda line: None)
        reads.append(float(sim.ss.energy.eion + sim.ss.energy.rk) - e0)
    np.testing.assert_allclose(reads, chip_smoke.C36_NVE_JAX, rtol=0,
                               atol=1e-7)
