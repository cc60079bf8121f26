"""The reference finding behind the mesh's item-25 refusals of slice 14's
integrators and box(t): the JAX ParallelSimulation reads the integrator
type only for its plan margin and its Berendsen barostat
(parallel_sim.py:214-217,272) and never reads box(t), so it runs NPTGLF
and NGLFNK decks as NGLF, thermostats an NVEGLF deck's LANGEVIN group and
keeps a STRAIN deck's box fixed, where a Simulation moves the box or
runs NVE (the port's Simulation stands for the JAX package's here:
tests/test_torch_npt_integrators.py and tests/test_torch_boxtime.py hold
the two equal on NPTGLF, NGLFNK and STRAIN runs, and it costs no JAX
compile).  Tolerance: the mesh runs equal to 1e-12 (f64, the same
arithmetic)."""


import numpy as np
import pytest

import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.parallel_sim import ParallelSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

EDITS = {
    "NPTGLF": chip_smoke.nptglf_edit(),
    "NGLFNK": chip_smoke.nglfnk_edit(W=200.0, P=2000.0),
    "NVEGLF": lambda t: t.replace("type=NGLF;", "type=NVEGLF;"),
    "STRAIN": chip_smoke.box_edit("dudt=0 0 1e-4;"),
}


def _run(d, steps=5):
    ps = ParallelSimulation(*j_load(d), shape=(1, 1, 1), dtype=jnp.float64)
    ps.first_energy()
    ps.run(steps)
    m = np.asarray(ps.mask).reshape(-1).astype(bool)
    return (np.asarray(ps.fields["r"]).reshape(-1, 3)[m],
            np.asarray(ps.fields["v"]).reshape(-1, 3)[m],
            np.asarray(ps.Lv))


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nglf"))
    chip_smoke.eam_deck(d, 4, 5)
    return d, _run(d)


@pytest.mark.parametrize("what", list(EDITS))
def test_jax_mesh_runs_it_as_nglf(tmp_path, base, what):
    """The edited deck's JAX mesh run equals the NGLF deck's (LANGEVIN
    300 K), box included; a Simulation's first step moves its box."""
    d = str(tmp_path)
    chip_smoke.eam_deck(d, 4, 5, edit=EDITS[what])
    got = _run(d)
    for a, b in zip(got, base[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    if what == "NVEGLF":
        return
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    ts.run(1, print_fn=lambda s: None)
    assert not np.allclose(ts.ss.box.lengths.numpy(), base[1][2],
                           rtol=1e-9, atol=0)
