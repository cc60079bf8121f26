"""Slice 15, the masters (ROADMAP item 23): testForce, thermalize and
eightFold against the JAX package's (testPressure's tables, the port's
CLI, integrationTest and unitTest: test_torch_masters_cli.py).

Tolerances (f64): testForce's analytic forces rel 1e-9, its finite
differences 1e-6 absolute (the cancellation of two energy sums);
thermalize's velocities bit-equal;
eightFold's files line for line.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run import masters as j_masters
from ddcmd_tpu.run.testforce import testforce_master as j_testforce
from ddcmd_tpu_torch.models import martini_water
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run import masters as t_masters
from ddcmd_tpu_torch.run.testforce import testforce_master as t_testforce

torch.set_num_threads(2)


def _deck(tmp_path, make, name="deck"):
    d = str(tmp_path / name)
    os.makedirs(d)
    make(d)
    return d


def test_testforce_rows_match_jax(tmp_path, capsys):
    """The sampled particles (np.random.default_rng(0)), their analytic
    and finite-difference forces and errors on the list engine, f64."""
    d = _deck(tmp_path, lambda d: martini_water(d, n=400))
    worst, rows = t_testforce(*t_load(d), device="cpu", dtype=torch.float64,
                              n_samples=3)
    capsys.readouterr()
    j_worst = j_testforce(*j_load(d), dtype=jnp.float64, n_samples=3)
    j_out = capsys.readouterr().out
    # the finite differences cancel two f64 energy sums taken in another
    # order: 1e-16 |E| / h ~ 1e-9 of |E| ~ 1e3 kJ/mol, so 1e-6 absolute
    assert worst == pytest.approx(j_worst, abs=1e-6)
    assert worst < 5e-3 and len(rows) == 9
    j_rows = [ln.split() for ln in j_out.splitlines()[1:-1]]
    assert [(r[0], r[1]) for r in rows] == [(int(a), int(b))
                                            for a, b, *_ in j_rows]
    np.testing.assert_allclose([r[2] for r in rows],
                               [float(r[2]) for r in j_rows], rtol=1e-9,
                               atol=1e-8)
    np.testing.assert_allclose([r[3] for r in rows],
                               [float(r[3]) for r in j_rows], atol=1e-6)


def test_thermalize_velocities_equal_jax(tmp_path):
    """thermalize draws on the host from the deck's seed: the port's
    velocities are the JAX package's bit for bit (f64), and the master
    writes a checkpoint the restart link names."""
    d = _deck(tmp_path, lambda d: martini_water(d, n=400))
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    ts = t_masters.thermalize_master(*t_load(d), run_dir=td, device="cpu",
                                     dtype=torch.float64)
    js = j_masters.thermalize_master(*j_load(d), run_dir=jd,
                                     dtype=jnp.float64)
    n = ts.sysdef.state.n_local
    assert np.array_equal(ts.ss.state.v[:n].numpy(),
                          np.asarray(js.ss.state.v)[:n])
    assert os.path.islink(os.path.join(td, "restart"))


def test_eightfold_files_equal_jax(tmp_path):
    """eightFold's atoms file and restart equal the JAX package's line
    for line; the replicated deck loads with 8 n particles, unique gids."""
    d = _deck(tmp_path, lambda d: martini_water(d, n=400))
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    for x in (jd, td):
        os.makedirs(x)
    t_masters.eightfold_master(*t_load(d), run_dir=td, device="cpu",
                               dtype=torch.float64)
    j_masters.eightfold_master(*j_load(d), run_dir=jd, dtype=jnp.float64)
    for name in ("atoms#000000", "restart"):
        with open(os.path.join(td, "snapshot.8fold", name)) as f:
            a = f.read().splitlines()
        with open(os.path.join(jd, "snapshot.8fold", name)) as f:
            assert a == f.read().splitlines()
    from ddcmd_tpu_torch.io.collection import read_collection

    col = read_collection("snapshot.8fold/atoms#", td)
    assert col.n == 3200 and len(set(col.gid)) == 3200
