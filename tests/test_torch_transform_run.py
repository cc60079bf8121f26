"""Slice 16, SIMULATE transform= at its rate (ROADMAP item 24a) against
the JAX package in f64 on the CPU: a FREE (NVE) deck whose REPLICATE at
rate 10 fires three times in a 30-step run.  Tolerances: positions
within 1e-8 of the box edge, velocities within 1e-8 of the largest |v|,
energies within 1e-8 relative, the printed rows within 1e-7."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)


def test_transform_at_its_rate_matches_jax(tmp_path):
    """A FREE (NVE) deck, the 300-atom LJ fluid, with SIMULATE
    transform= REPLICATE nx=2 at rate 10: 30 steps in both packages in
    f64 replicate at loops 10, 20 and 30 (300 -> 2,400 atoms); the
    positions, velocities and energies after it held to the JAX
    package's."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    chip_smoke.lj_deck(d, 300, printrate=10, free=True, edit=lambda s: (
        s.replace("type=MD;", "type=MD; transform=rep;", 1)
        + "rep TRANSFORM { type=REPLICATE; nx=2; ny=1; nz=1; rate=10; }\n"))
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    assert [(t, r) for t, _, r in ts.transforms] == [("rep", 10)]
    rows = {}
    for where, sim in (("jax", js), ("torch", ts)):
        rows[where] = []
        sim.run(30, print_fn=rows[where].append)
        assert int(sim.ss.loop) == 30 and sim.sysdef.state.n_local == 2400
    n = 2400
    edge = float(ts.ss.box.h.max())
    np.testing.assert_allclose(ts.ss.state.r[:n].numpy(),
                               np.asarray(js.ss.state.r[:n]), rtol=0,
                               atol=1e-8 * edge)
    jv = np.asarray(js.ss.state.v[:n])
    np.testing.assert_allclose(ts.ss.state.v[:n].numpy(), jv, rtol=0,
                               atol=1e-8 * np.abs(jv).max())
    for k in ("eion", "rk"):
        assert float(getattr(ts.ss.energy, k)) == pytest.approx(
            float(getattr(js.ss.energy, k)), rel=1e-8)
    # the printed rows (loops 10, 20, 30) count the particles of their
    # step: 300, 600, 1,200 before each replica
    assert len(rows["torch"]) == len(rows["jax"]) == 3
    for a, b in zip(rows["torch"], rows["jax"]):
        np.testing.assert_allclose(
            np.array(a.split(), dtype=float), np.array(b.split(),
                                                       dtype=float),
            rtol=1e-7, atol=1e-7)
